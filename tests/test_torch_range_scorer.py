"""Port range scorer vs the JAX reference: plain versions and kernel wrappers.

The same inputs, made with numpy from a seed, go through the JAX package's
``ref`` functions and Pallas kernels (interpret mode, as its own tests run
them) and through the port's plain PyTorch functions. On the CPU the port's
kernel wrappers return their plain versions, so the ``impl="cuda"`` path of
``score_blocks`` runs here too, around the plain scatter and decode. Every
comparison is exact: the scorer is integer end to end.

``tests/test_torch_cuda.py`` holds the CUDA kernels against the plain
versions on the card.
"""

from __future__ import annotations

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.clustered_index import pack_dir_entries as jax_pack_dir_entries
from repro.core.clustered_index import pack_docs as jax_pack_docs
from repro.kernels.range_scorer import ref as jref
from repro.kernels.range_scorer.kernel import (
    scatter_accumulate_pallas,
    unpack_locals_pallas,
)
from repro.kernels.range_scorer.ops import score_blocks as jax_score_blocks
from repro_torch.core.clustered_index import pack_dir_entries, pack_docs
from repro_torch.core.range_daat import pack_impacts
from repro_torch.kernels.range_scorer import kernel, ops, ref

BLOCK = ref.BLOCK


def _t(x, dtype=None) -> torch.Tensor:
    a = np.asarray(x)
    return torch.from_numpy(np.ascontiguousarray(a if dtype is None else a.astype(dtype)))


def _np(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _random_case(rng, nnz, n_blocks, s_range):
    docs = np.sort(rng.integers(0, s_range, size=nnz)).astype(np.int32)
    imps = rng.integers(1, 256, size=nnz).astype(np.int32)
    starts = rng.integers(0, max(nnz - BLOCK, 1), size=n_blocks).astype(np.int32)
    lens = rng.integers(1, BLOCK + 1, size=n_blocks).astype(np.int32)
    lens = np.minimum(lens, nnz - starts).astype(np.int32)
    keep = rng.random(n_blocks) < 0.8
    return docs, imps, starts, lens, keep


def _packed_pool(rng, n_pool, max_deltas=(0, 1, 200, 255, 300, 70_000)):
    """Pool of contiguous blocks spanning every pack width, pre-packed."""
    blk_len = rng.integers(1, BLOCK + 1, size=n_pool).astype(np.int64)
    blk_start = np.cumsum(blk_len) - blk_len
    chunks = []
    for length in blk_len:
        md = int(rng.choice(max_deltas))
        d = np.zeros(int(length), np.int64)
        if md:
            d[1:] = rng.integers(0, md + 1, size=int(length) - 1)
        chunks.append(int(rng.integers(0, 500)) + np.cumsum(d))
    docs = np.concatenate(chunks).astype(np.int64)
    packed = pack_docs(docs, blk_start, blk_len)
    imps = rng.integers(1, 256, size=docs.shape[0]).astype(np.int32)
    return docs, imps, blk_start, blk_len, packed


def _select(packed, blk_start, blk_len, sel):
    """Per-query directory columns for the selected blocks (engine layout)."""
    return dict(
        starts=blk_start[sel].astype(np.int32),
        lens=blk_len[sel].astype(np.int32),
        pack_dir=pack_dir_entries(packed)[sel].astype(np.int32),
        pack_firsts=packed.blk_first[sel].astype(np.int32),
    )


def _words(packed) -> torch.Tensor:
    """The port's device layout of the stream: int32 carrying uint32 bits."""
    return _t(np.asarray(packed.words, np.uint32).view(np.int32))


@pytest.mark.parametrize("impact_dtype", ["int32", "int8"])
@pytest.mark.parametrize("s_pad", [128, 384, 1024])
@pytest.mark.parametrize("n_blocks", [1, 7, 32])
def test_score_blocks_matches_jax(impact_dtype, s_pad, n_blocks):
    """Gather, scatter and score_blocks == the JAX ref and Pallas kernel."""
    rng = np.random.default_rng(s_pad * 1000 + n_blocks)
    docs, imps, starts, lens, keep = _random_case(rng, 5000, n_blocks, s_pad)
    stored = pack_impacts(imps, impact_dtype)
    r0 = 3
    j_local, j_vals = jref.gather_block_postings(
        jnp.asarray(docs), jnp.asarray(stored), jnp.asarray(starts),
        jnp.asarray(lens), jnp.asarray(keep), jnp.int32(r0),
    )
    t_local, t_vals = ref.gather_block_postings(
        _t(docs), _t(stored), _t(starts), _t(lens), _t(keep), r0
    )
    np.testing.assert_array_equal(_np(t_local), np.asarray(j_local))
    np.testing.assert_array_equal(_np(t_vals), np.asarray(j_vals))
    assert t_local.dtype == t_vals.dtype == torch.int32

    expect = np.asarray(jref.score_blocks_ref(
        jnp.asarray(docs), jnp.asarray(stored), jnp.asarray(starts),
        jnp.asarray(lens), jnp.asarray(keep), jnp.int32(r0), s_pad,
    ))
    pallas = np.asarray(scatter_accumulate_pallas(j_local, j_vals, s_pad=s_pad))
    np.testing.assert_array_equal(pallas, expect)
    np.testing.assert_array_equal(
        _np(kernel.scatter_accumulate(t_local, t_vals, s_pad)), expect
    )
    for impl in ops.IMPLS:
        got = ops.score_blocks(
            _t(docs), _t(stored), _t(starts), _t(lens), _t(keep),
            torch.tensor(r0, dtype=torch.int32), s_pad=s_pad, impl=impl,
        )
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(_np(got), expect, err_msg=impl)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scatter_accumulate_drops_out_of_range_ids(seed):
    """Ids < 0 and ids >= s_pad are dropped, as by the Pallas kernel."""
    rng = np.random.default_rng(seed)
    P, S = 3000, 900
    ids = rng.integers(-1, S + 200, size=P).astype(np.int32)
    vals = rng.integers(0, 256, size=P).astype(np.int32)
    expect = np.zeros(S, np.int64)
    ok = (ids >= 0) & (ids < S)
    np.add.at(expect, ids[ok], vals[ok])
    pallas = scatter_accumulate_pallas(
        jnp.asarray(ids), jnp.asarray(vals), s_pad=S, s_tile=128, p_tile=512
    )
    np.testing.assert_array_equal(np.asarray(pallas, np.int64), expect)
    got = kernel.scatter_accumulate(_t(ids), _t(vals), S)
    np.testing.assert_array_equal(_np(got).astype(np.int64), expect)


def test_unpack_dir_matches_jax():
    rng = np.random.default_rng(4)
    _, _, _, _, packed = _packed_pool(rng, 24)
    entries = pack_dir_entries(packed)
    ws_j, w_j = jref.unpack_dir(jnp.asarray(entries))
    ws_t, w_t = ref.unpack_dir(_t(entries))
    np.testing.assert_array_equal(_np(ws_t), np.asarray(ws_j))
    np.testing.assert_array_equal(_np(w_t), np.asarray(w_j))


@pytest.mark.parametrize("impact_dtype", ["int32", "int8"])
@pytest.mark.parametrize("seed", [0, 3, 9])
def test_packed_decode_matches_jax_across_widths(seed, impact_dtype):
    """Every width 0..32 in one call: port == JAX ref == Pallas kernel."""
    rng = np.random.default_rng(seed)
    docs, imps, blk_start, blk_len, packed = _packed_pool(rng, 24)
    assert {0, 4, 8, 16, 32} <= set(packed.blk_width.tolist())
    # The port's copy of the codec writes the reference's stream bitwise.
    j_packed = jax_pack_docs(docs, blk_start, blk_len)
    np.testing.assert_array_equal(packed.words, j_packed.words)
    np.testing.assert_array_equal(
        pack_dir_entries(packed), jax_pack_dir_entries(j_packed)
    )
    sel = rng.integers(0, 24, size=17)  # duplicates allowed, like a query
    cols = _select(packed, blk_start, blk_len, sel)
    keep = rng.random(17) < 0.8
    stored = pack_impacts(imps, impact_dtype)
    r0 = int(rng.integers(0, 100))
    jc = {k: jnp.asarray(v) for k, v in cols.items()}
    j_local, j_vals = jref.gather_block_postings_packed(
        jnp.asarray(packed.words), jnp.asarray(stored), jc["starts"], jc["lens"],
        jc["pack_dir"], jc["pack_firsts"], jnp.asarray(keep), jnp.int32(r0),
    )
    pallas = unpack_locals_pallas(
        jnp.asarray(packed.words), jc["starts"], jc["lens"],
        jc["pack_dir"], jc["pack_firsts"], jnp.asarray(keep), jnp.int32(r0),
    )
    np.testing.assert_array_equal(np.asarray(pallas), np.asarray(j_local))

    tc = {k: _t(v) for k, v in cols.items()}
    t_local, t_vals = ref.gather_block_postings_packed(
        _words(packed), _t(stored), tc["starts"], tc["lens"],
        tc["pack_dir"], tc["pack_firsts"], _t(keep), r0,
    )
    np.testing.assert_array_equal(_np(t_local), np.asarray(j_local))
    np.testing.assert_array_equal(_np(t_vals), np.asarray(j_vals))
    got = kernel.unpack_locals(
        _words(packed), tc["starts"], tc["lens"], tc["pack_dir"],
        tc["pack_firsts"], _t(keep), r0,
    )
    np.testing.assert_array_equal(_np(got), np.asarray(j_local))


def test_packed_decode_pruned_and_padding_rows():
    """keep=False rows and starts==-1 padding rows decode to all -1."""
    rng = np.random.default_rng(5)
    _, imps, blk_start, blk_len, packed = _packed_pool(rng, 8)
    cols = _select(packed, blk_start, blk_len, np.arange(8))
    # Engine-style padding rows: starts == -1, directory columns carry the
    # clamped gather of a real block (index 0), exactly what safe_ids does.
    starts = np.concatenate([cols["starts"], [-1, -1]]).astype(np.int32)
    pad = lambda c: np.concatenate([c, c[:1], c[:1]]).astype(np.int32)
    lens, pd, pf = pad(cols["lens"]), pad(cols["pack_dir"]), pad(cols["pack_firsts"])
    for keep in (np.zeros(10, bool), np.ones(10, bool)):
        pallas = np.asarray(unpack_locals_pallas(
            jnp.asarray(packed.words), jnp.asarray(starts), jnp.asarray(lens),
            jnp.asarray(pd), jnp.asarray(pf), jnp.asarray(keep), jnp.int32(0),
        ))
        got = _np(kernel.unpack_locals(
            _words(packed), _t(starts), _t(lens), _t(pd), _t(pf), _t(keep), 0
        ))
        np.testing.assert_array_equal(got, pallas)
        assert np.all(got.reshape(10, BLOCK)[8:] == -1)
        if not keep.any():
            assert np.all(got == -1)


def test_score_blocks_packed_parity_straddling_width_change():
    """One scored range spanning a width change: every path agrees."""
    rng = np.random.default_rng(11)
    docs, imps, blk_start, blk_len, packed = _packed_pool(
        rng, 12, max_deltas=(0, 1, 7)
    )
    assert len(set(packed.blk_width.tolist())) >= 2  # widths change mid-range
    s_pad = int(docs.max()) + 1
    cols = _select(packed, blk_start, blk_len, np.arange(12))
    keep = rng.random(12) < 0.9
    tc = {k: _t(v) for k, v in cols.items()}
    for r0 in (0, 3):
        base = np.asarray(jax_score_blocks(
            jnp.asarray(docs, jnp.int32), jnp.asarray(imps),
            jnp.asarray(cols["starts"]), jnp.asarray(cols["lens"]),
            jnp.asarray(keep), jnp.int32(r0), s_pad=s_pad, impl="xla",
        ))
        for impl in ops.IMPLS:
            got = ops.score_blocks(
                torch.zeros(1, dtype=torch.int32), _t(imps), tc["starts"],
                tc["lens"], _t(keep), torch.tensor(r0, dtype=torch.int32),
                s_pad=s_pad, impl=impl, docs_format="packed",
                pack_words=_words(packed), pack_dir=tc["pack_dir"],
                pack_firsts=tc["pack_firsts"],
            )
            np.testing.assert_array_equal(_np(got), base, err_msg=f"{impl} r0={r0}")


def test_score_blocks_rejects_bad_arguments():
    z = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="pack_"):
        ops.score_blocks(z, z, z, z + 1, torch.ones(1, dtype=torch.bool), 0,
                         s_pad=128, docs_format="packed")
    with pytest.raises(ValueError, match="impl"):
        ops.score_blocks(z, z, z, z + 1, torch.ones(1, dtype=torch.bool), 0,
                         s_pad=128, impl="pallas")


def test_wrappers_check_inputs_and_count_only_launches():
    """Wrong dtypes raise; the CPU's plain versions are not launches."""
    ids = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(TypeError, match="int32"):
        kernel.scatter_accumulate(ids.to(torch.int64), ids, 8)
    with pytest.raises(ValueError, match="differ"):
        kernel.scatter_accumulate(ids, ids[:2], 8)
    with pytest.raises(TypeError, match="keep"):
        kernel.unpack_locals(ids, ids, ids, ids, ids, ids, 0)
    before = (kernel.scatter_accumulate.launches, kernel.unpack_locals.launches)
    kernel.scatter_accumulate(ids, ids, 8)
    kernel.unpack_locals(ids, ids, ids, ids, ids, torch.ones(4, dtype=torch.bool), 0)
    after = (kernel.scatter_accumulate.launches, kernel.unpack_locals.launches)
    assert after == before


def _source_constants() -> dict:
    src = Path(kernel.SOURCE).read_text()
    return {m.group(1): int(m.group(2)) for m in
            re.finditer(r"constexpr int (k\w+) = (\d+);", src)}


def test_scatter_plan_mirrors_the_source():
    """kernel.py's scatter constants and placement codes are the .cu's."""
    c = _source_constants()
    assert c["kScatterThreads"] == kernel.SCATTER_THREADS
    assert c["kScatterCtaSlots"] == kernel.SCATTER_CTA_SLOTS
    assert c["kScatterLoneSlots"] == kernel.SCATTER_LONE_SLOTS
    assert c["kScatterLonePostings"] == kernel.SCATTER_LONE_POSTINGS
    assert c["kScatterPortableCluster"] == kernel.SCATTER_PORTABLE_CLUSTER == 8
    assert c["kScatterMaxCluster"] == kernel.SCATTER_MAX_CLUSTER
    assert kernel._SCATTER_CODES == {"cta": c["kScatterLone"],
                                     "cluster": c["kScatterCluster"],
                                     "clusters": c["kScatterCluster"],
                                     "global": c["kScatterGlobal"]}
    # A CTA's slice fits the opt-in beside nothing else; a cluster is at
    # most 16 CTAs, the widest that sm_90 schedules at all.
    assert kernel.SCATTER_CTA_SLOTS * 4 <= kernel.SMEM_OPT_IN
    assert kernel.SCATTER_CTA_SLOTS % 4 == kernel.SCATTER_LONE_SLOTS % 4 == 0
    assert kernel.SCATTER_LONE_SLOTS <= kernel.SCATTER_CTA_SLOTS
    assert kernel.SCATTER_PORTABLE_CLUSTER <= kernel.SCATTER_MAX_CLUSTER <= 16


LONE, LONE_P = kernel.SCATTER_LONE_SLOTS, kernel.SCATTER_LONE_POSTINGS
MC = kernel.SCATTER_MAX_CLUSTER
ONE_CLUSTER = kernel.SCATTER_CTA_SLOTS * MC


@pytest.mark.parametrize("P,s_pad,want", [
    (0, 1, ("cta", 1, 1, 4)),
    (1, 1, ("cta", 1, 1, 4)),
    (4096, 9_984, ("cta", 1, 1, 9_984)),
    (LONE_P, LONE, ("cta", 1, 1, LONE)),
    (LONE_P, LONE + 1, ("cluster", MC, 1, 772)),
    (LONE_P + 1, 9_984, ("cluster", MC, 1, 624)),
    (LONE_P + 1, 1, ("cluster", MC, 1, 4)),
    (0, ONE_CLUSTER, ("cluster", MC, 1, kernel.SCATTER_CTA_SLOTS)),
    (0, ONE_CLUSTER + 1, ("global", 0, 0, 0)),
    (1_048_576, 409_600, ("cluster", MC, 1, 409_600 // MC)),
    (1_048_576, 1_572_864, ("global", 0, 0, 0)),
])
def test_scatter_plan_edges(P, s_pad, want):
    """One CTA's capacity in slots and in postings and one more, one
    cluster's capacity and a slot more, s_pad = 1, P = 0, the two full
    collection ranges: every shared-memory plan covers s_pad with whole
    quads of slots that fit a CTA."""
    plan = kernel.scatter_plan(P, s_pad)
    assert tuple(plan) == want
    if plan.placement != "global":
        assert plan.slots % 4 == 0 and 4 <= plan.slots <= kernel.SCATTER_CTA_SLOTS
        assert plan.cluster * plan.clusters * plan.slots >= s_pad
        assert (plan.cluster == 1) == (plan.placement == "cta")


@pytest.mark.parametrize("args", [(-1, 8), (0, 0), (4, -3)])
def test_scatter_plan_refuses_bad_sizes(args):
    with pytest.raises(ValueError, match="scatter_plan"):
        kernel.scatter_plan(*args)


def test_scatter_accumulate_takes_no_postings_on_the_cpu():
    """P = 0 gives s_pad zeros; the plain version is no launch."""
    before = kernel.scatter_accumulate.launches
    empty = torch.zeros(0, dtype=torch.int32)
    got = kernel.scatter_accumulate(empty, empty, 5)
    assert torch.equal(got, torch.zeros(5, dtype=torch.int32))
    assert kernel.scatter_accumulate.launches == before
    with pytest.raises(ValueError, match="card"):
        kernel.noop(torch.device("cpu"))


def test_find_nvcc_prefers_cuda_home(tmp_path, monkeypatch):
    fake = tmp_path / "bin" / "nvcc"
    fake.parent.mkdir()
    fake.write_text("#!/bin/sh\n")
    fake.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    assert kernel.find_nvcc() == str(fake)


def test_find_nvcc_raises_when_missing(tmp_path, monkeypatch):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernel.find_nvcc()
