"""The fused range step vs the JAX reference's ``score_range_step``, on the CPU.

``kernels.range_scorer.ref.range_step_ref`` is the plain version of the
``range_step`` CUDA kernel: one whole range step (block pruning, gather,
optional packed decode, scatter, range top-k, merge into the running
state). Here it, and the kernel's wrapper on CPU tensors (which returns
it), are held bitwise against the JAX package's ``score_range_step`` under
``impl="xla"`` and ``impl="pallas"`` (interpret mode, as the reference's own
tests run it): every range of a few queries over the four configurations
(int32/int8 impacts × int32/packed docids) with block pruning on and off,
then constructed ties at the k-th score, an all-pruned range and a range
with no blocks. ``tests/test_torch_cuda.py`` holds the kernel against the
plain version on the card.
"""

from __future__ import annotations

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import range_daat as jax_daat
from repro.core.clustered_index import pack_dir_entries as jax_pack_dir_entries
from repro.core.clustered_index import pack_docs as jax_pack_docs
from repro_torch.core import range_daat
from repro_torch.core.clustered_index import INDEX_ARRAYS, index_from_arrays
from repro_torch.kernels.range_scorer import kernel, ref

CONFIGS = [(dt, fmt) for dt in ("int32", "int8") for fmt in ("int32", "packed")]
BLOCK = ref.BLOCK


@pytest.fixture(scope="module")
def port_idx(index):
    arrays = {n: getattr(index, n) for n in INDEX_ARRAYS
              if n not in ("doc_order", "range_ends")}
    arrays["doc_order"] = index.arrangement.doc_order
    arrays["range_ends"] = index.arrangement.range_ends
    return index_from_arrays(
        arrays, n_docs=index.n_docs, n_terms=index.n_terms,
        strategy=index.arrangement.strategy, quant_bits=index.quantizer.bits,
        quant_scale=index.quantizer.scale,
    )


def _np(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_state_equal(jstate, tstate, ctx):
    np.testing.assert_array_equal(_np(tstate.vals), np.asarray(jstate.vals), ctx)
    np.testing.assert_array_equal(_np(tstate.ids), np.asarray(jstate.ids), ctx)
    assert int(tstate.postings) == int(jstate.postings), ctx
    assert int(tstate.blocks) == int(jstate.blocks), ctx
    for t in tstate:
        assert t.dtype == torch.int32, ctx


def _port_state(jstate) -> ref.TopKState:
    """A JAX state carried into the port's buffer layout."""
    k = np.asarray(jstate.vals).shape[0]
    buf = np.concatenate([np.asarray(jstate.vals), [int(jstate.postings)],
                          [int(jstate.blocks)], np.asarray(jstate.ids)])
    return ref.state_views(torch.from_numpy(buf.astype(np.int32)), k)


@pytest.mark.parametrize("prune_blocks", [True, False])
@pytest.mark.parametrize("impact_dtype,docs_format", CONFIGS)
def test_range_step_matches_jax_every_range(index, port_idx, queries, impact_dtype,
                                            docs_format, prune_blocks):
    """range_step_ref and the wrapper == JAX xla (and pallas) after every range."""
    jeng = jax_daat.Engine(index, k=10, impl="xla", impact_dtype=impact_dtype,
                           docs_format=docs_format)
    port = range_daat.Engine(port_idx, k=10, device="cpu", impact_dtype=impact_dtype,
                             docs_format=docs_format)
    kw = dict(s_pad=port.s_pad, k=port.k, prune_blocks=prune_blocks,
              docs_format=docs_format)
    for qi, q in enumerate(queries[:3]):
        jplan, tplan = jeng.plan(q), port.plan(q)
        js, rs_, ks = jeng.init_state(), port.init_state(), port.init_state()
        for i in range(index.n_ranges):
            r = int(jplan.order_host[i])
            jargs = (jplan.blk_tab[r], jplan.rest_tab[r], jeng.dix.range_starts[r])
            targs = (tplan.blk_tab[r], tplan.rest_tab[r], port.dix.range_starts[r])
            if qi == 0:  # the Pallas kernels, interpret mode, from the same state
                jp = jax_daat.score_range_step(jeng.dix, js, *jargs, impl="pallas",
                                               interpret=True, **kw)
                _assert_state_equal(jp, ref.range_step_ref(port.dix, _port_state(js),
                                                           *targs, **kw),
                                    f"pallas query {qi} range {i}")
            js = jax_daat.score_range_step(jeng.dix, js, *jargs, impl="xla", **kw)
            rs_ = ref.range_step_ref(port.dix, rs_, *targs, **kw)
            ks = kernel.range_step(port.dix, ks, *targs, **kw)
            _assert_state_equal(js, rs_, f"ref query {qi} range {i}")
            _assert_state_equal(js, ks, f"wrapper query {qi} range {i}")


def _tie_index(impact_dtype: str, docs_format: str):
    """One range of 256 docs whose blocks make many equal sums.

    Blocks 0-1 hold every doc once (impact 5), blocks 2-3 every doc again
    (impact 5), block 4 docs 0..127 with impact 3: so docs 0..127 tie at 13
    and docs 128..255 at 10. Returned as (JAX dix, port dix).
    """
    docs = np.concatenate([np.arange(0, 256, 2), np.arange(1, 256, 2),
                           np.arange(0, 128), np.arange(128, 256),
                           np.arange(0, 128)]).astype(np.int64) + 40
    imps = np.concatenate([np.full(512, 5), np.full(128, 3)]).astype(np.int64)
    starts = np.arange(0, 640, 128, dtype=np.int64)
    lens = np.full(5, 128, np.int64)
    maximp = np.array([5, 5, 5, 5, 3], np.int64)
    if impact_dtype == "int8":
        stored = (imps - ref.IMPACT_BIAS).astype(np.int8)
    else:
        stored = imps.astype(np.int32)
    cols = dict(docs=docs.astype(np.int32), impacts=stored,
                blk_start=starts.astype(np.int32), blk_len=lens.astype(np.int32),
                blk_maximp=maximp.astype(np.int32),
                bounds_dense=np.zeros((1, 1), np.int32),
                range_starts=np.array([40], np.int32),
                range_sizes=np.array([256], np.int32))
    if docs_format == "packed":
        jpk = jax_pack_docs(docs, starts, lens)
        cols["docs"] = np.zeros(1, np.int32)
        cols["pack_words"] = np.asarray(jpk.words, np.uint32)
        cols["pack_dir"] = jax_pack_dir_entries(jpk).astype(np.int32)
        cols["pack_first"] = np.asarray(jpk.blk_first, np.int32)
    jdix = jax_daat.DeviceIndex(**{n: jnp.asarray(a) for n, a in cols.items()})
    if docs_format == "packed":
        cols["pack_words"] = cols["pack_words"].view(np.int32)
    tdix = range_daat.DeviceIndex(**{n: torch.from_numpy(a) for n, a in cols.items()})
    return jdix, tdix


def _jax_state(vals, ids, postings=0, blocks=0):
    return jax_daat.TopKState(vals=jnp.asarray(vals, jnp.int32),
                              ids=jnp.asarray(ids, jnp.int32),
                              postings=jnp.int32(postings), blocks=jnp.int32(blocks))


# (label, blk ids, rest, state maker). The state makers take k.
_TIE_CASES = [
    ("ties at the k-th score, empty state", [0, 1, 2, 3, 4, -1, -1, -1], 0, None),
    # θ = 13 with ids above and below the tied range docs: ties against the
    # state's own entries at the k-th score, decided by id.
    ("ties against the state", [0, 1, 2, 3, 4, -1, -1, -1], 20, "theta13"),
    # θ = 100: every block's max impact + rest = 5 + 0 <= θ, so all pruned.
    ("all pruned", [0, 1, 2, 3, 4, -1, -1, -1], 0, "theta100"),
    ("no blocks", [-1] * 8, 0, "theta13"),
]


def _tie_state(kind, k):
    if kind is None:
        return jax_daat.init_state(k)
    top = 13 if kind == "theta13" else 100
    vals = np.full(k, top, np.int32)
    vals[: k // 2] = top + 7
    # Docs of other ranges, below and above this range's [40, 296): at the
    # k-th score the lower ones beat the range's tied docs, the upper lose.
    i = np.arange(k, dtype=np.int32)
    ids = np.where(i < 40, i, 296 + i).astype(np.int32)
    return _jax_state(vals, ids, postings=11, blocks=2)


@pytest.mark.parametrize("k", [1, 10, 100])
@pytest.mark.parametrize("impact_dtype,docs_format", CONFIGS)
def test_range_step_constructed_cases(k, impact_dtype, docs_format):
    """Ties at the k-th score, all-pruned and block-free ranges: exact."""
    jdix, tdix = _tie_index(impact_dtype, docs_format)
    kw = dict(s_pad=256, k=k, docs_format=docs_format)
    for label, blk, rest, kind in _TIE_CASES:
        blk = np.asarray(blk, np.int32)
        rest = np.full(blk.shape[0], rest, np.int32)
        for prune in (True, False):
            js0 = _tie_state(kind, k)
            want = jax_daat.score_range_step(
                jdix, js0, jnp.asarray(blk), jnp.asarray(rest), jnp.int32(40),
                impl="xla", prune_blocks=prune, **kw)
            targs = (torch.from_numpy(blk), torch.from_numpy(rest),
                     torch.tensor(40, dtype=torch.int32))
            ts0 = _port_state(js0)
            ctx = f"{label}, prune={prune}, k={k}"
            _assert_state_equal(want, ref.range_step_ref(tdix, ts0, *targs,
                                                         prune_blocks=prune, **kw), ctx)
            _assert_state_equal(want, kernel.range_step(tdix, ts0, *targs,
                                                        prune_blocks=prune, **kw), ctx)
            if label == "all pruned" and prune:
                assert int(want.blocks) == 2 and int(want.postings) == 11
    # The tie rule itself: with an empty state the lowest docids of the
    # k-th score win, as lax.top_k and the lexsort merge order them.
    ts = ref.range_step_ref(tdix, ref.init_state(k), torch.tensor([0, 1, 2, 3, 4]),
                            torch.zeros(5, dtype=torch.int32),
                            torch.tensor(40, dtype=torch.int32), **kw)
    assert _np(ts.ids).tolist() == list(range(40, 40 + k))


def test_range_step_with_no_block_rows_matches_jax():
    """B = 0: the state comes back unchanged, counters included."""
    jdix, tdix = _tie_index("int32", "int32")
    js0 = _tie_state("theta13", 10)
    want = jax_daat.score_range_step(jdix, js0, jnp.zeros(0, jnp.int32),
                                     jnp.zeros(0, jnp.int32), jnp.int32(40),
                                     s_pad=256, k=10)
    got = kernel.range_step(tdix, _port_state(js0), torch.zeros(0, dtype=torch.int32),
                            torch.zeros(0, dtype=torch.int32),
                            torch.tensor(40, dtype=torch.int32), s_pad=256, k=10)
    _assert_state_equal(want, got, "B = 0")
    _assert_state_equal(js0, got, "B = 0 leaves the state")


def test_score_range_step_cuda_reaches_only_range_step(port_idx, queries, monkeypatch):
    """impl="cuda" on CPU tensors: one range_step call, no standalone kernel."""
    calls = {"range_step": 0, "scatter_accumulate": 0, "unpack_locals": 0}

    def spy(name):
        real = getattr(kernel, name)

        def wrapped(*a, **kw):
            calls[name] += 1
            return real(*a, **kw)
        return wrapped

    real_step = kernel.range_step
    before = real_step.launches
    for name in calls:
        monkeypatch.setattr(kernel, name, spy(name))
    port = range_daat.Engine(port_idx, k=10, device="cpu", docs_format="packed")
    plan = port.plan(queries[0])
    r = int(plan.order_host[0])
    state = range_daat.score_range_step(
        port.dix, port.init_state(), plan.blk_tab[r], plan.rest_tab[r],
        port.dix.range_starts[r], s_pad=port.s_pad, k=port.k, impl="cuda",
        docs_format="packed")
    assert calls == {"range_step": 1, "scatter_accumulate": 0, "unpack_locals": 0}
    assert real_step.launches == before  # CPU tensors launch nothing
    want = range_daat.score_range_step(
        port.dix, port.init_state(), plan.blk_tab[r], plan.rest_tab[r],
        port.dix.range_starts[r], s_pad=port.s_pad, k=port.k, impl="torch",
        docs_format="packed")
    for a, b in zip(state, want):
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def wide_pair(random_index):
    """The reference's and the port's engine over one 2,500-doc range
    (s_pad 2,560), where k may exceed 1,024: (JAX index, port index)."""
    return random_index, _port_index(random_index)


def _port_index(index):
    arrays = {n: getattr(index, n) for n in INDEX_ARRAYS
              if n not in ("doc_order", "range_ends")}
    arrays["doc_order"] = index.arrangement.doc_order
    arrays["range_ends"] = index.arrangement.range_ends
    return index_from_arrays(
        arrays, n_docs=index.n_docs, n_terms=index.n_terms,
        strategy=index.arrangement.strategy, quant_bits=index.quantizer.bits,
        quant_scale=index.quantizer.scale,
    )


def test_range_step_wrapper_checks_k_and_inputs(port_idx, wide_pair, queries):
    """Any 1 <= k <= s_pad: the wrapper at k = 1,025 and k = s_pad equals the
    reference's score_range_step over two ranges; k = 0 and k > s_pad raise."""
    jindex, tindex = wide_pair
    for k in (1025, None):
        jeng = jax_daat.Engine(jindex, k=10, impl="xla")
        port = range_daat.Engine(tindex, k=10, device="cpu")
        k = port.s_pad if k is None else k
        kw = dict(s_pad=port.s_pad, k=k)
        js, ts = jax_daat.init_state(k), ref.init_state(k)
        for qi, q in enumerate(queries[:2]):
            jplan, tplan = jeng.plan(q), port.plan(q)
            r = int(jplan.order_host[0])
            js = jax_daat.score_range_step(
                jeng.dix, js, jplan.blk_tab[r], jplan.rest_tab[r],
                jeng.dix.range_starts[r], impl="xla", **kw)
            ts = kernel.range_step(port.dix, ts, tplan.blk_tab[r], tplan.rest_tab[r],
                                   port.dix.range_starts[r], **kw)
            _assert_state_equal(js, ts, f"k={k} step {qi}")
    port = range_daat.Engine(port_idx, k=10, device="cpu")
    blk = torch.zeros(4, dtype=torch.int32)
    rs = torch.tensor(0, dtype=torch.int32)
    for k, s_pad in ((0, 256), (300, 256), (257, 256)):
        with pytest.raises(ValueError, match="1 <= k <= s_pad"):
            kernel.range_step(port.dix, ref.init_state(max(k, 1)), blk, blk, rs,
                              s_pad=s_pad, k=k)
    with pytest.raises(TypeError, match="blk_ids"):
        kernel.range_step(port.dix, ref.init_state(10), blk.long(), blk, rs,
                          s_pad=256, k=10)
    with pytest.raises(ValueError, match="state holds"):
        kernel.range_step(port.dix, ref.init_state(5), blk, blk, rs, s_pad=256, k=10)
    with pytest.raises(ValueError, match="pack_words"):
        kernel.range_step(port.dix, ref.init_state(10), blk, blk, rs, s_pad=256, k=10,
                          docs_format="packed")
    with pytest.raises(ValueError, match="docs_format"):
        kernel.range_step(port.dix, ref.init_state(10), blk, blk, rs, s_pad=256, k=10,
                          docs_format="raw")


def test_engine_cuda_impl_states_the_k_limit(wide_pair, queries):
    """The k limit is the reference's, s_pad: Engine(k=1500) equals the
    reference on every observe_query field, and k above s_pad raises at the
    kernel's wrapper, as lax.top_k raises in the reference."""
    from differential import assert_results_equal, observe_query

    jindex, tindex = wide_pair
    ref_eng = jax_daat.Engine(jindex, k=1500, impl="xla")
    port = range_daat.Engine(tindex, k=1500, device="cpu")
    assert port.s_pad >= 1500
    for i, q in enumerate(queries[:4]):
        for budget in (None, 900):
            assert_results_equal(
                observe_query(ref_eng, ref_eng.plan(q), budget),
                observe_query(port, port.plan(q), budget),
                context=f"query {i} budget {budget}: reference vs port at k=1500",
            )
    big = port.s_pad + 1
    with pytest.raises(Exception):
        eng = jax_daat.Engine(jindex, k=big, impl="xla")
        eng.traverse(eng.plan(queries[0]))
    eng = range_daat.Engine(tindex, k=big, device="cpu")
    with pytest.raises(RuntimeError):
        eng.traverse(eng.plan(queries[0]))
    with pytest.raises(ValueError, match="1 <= k <= s_pad"):
        kernel.traverse(eng.dix, *[None] * 7, s_pad=eng.s_pad, k=big)


def test_kernel_limits_mirror_the_source():
    """kernel.py's placement constants are the .cu's; the limits follow k."""
    src = Path(kernel.SOURCE).read_text()
    const = {m.group(1): m.group(2) for m in
             re.finditer(r"constexpr int (k\w+) = ([^;]+);", src)}
    env = {}
    for name in ("kCandCap", "kTouchedCap", "kTopSharedMax", "kSmemOptIn",
                 "kStaticReserve"):
        expr = re.sub(r"//.*", "", const[name]).strip()
        env[name] = int(eval(expr.replace("/", "//"), {}, env))
    assert env["kCandCap"] == kernel.CAND_CAP
    assert env["kTouchedCap"] == kernel.TOUCHED_CAP
    assert env["kTopSharedMax"] == kernel.TOP_SHARED_MAX
    assert env["kSmemOptIn"] == kernel.SMEM_OPT_IN == 232_448
    assert env["kStaticReserve"] == kernel.STATIC_RESERVE
    # cap_c(k) = next_pow2(max(k, 32)) keys, the state copy, traverse's states.
    assert kernel.top_bytes(10) == 8 * 32 + 8 * 10
    assert kernel.top_bytes(1025, "traverse") == 8 * 2048 + 8 * 1025 + 8 * 2052
    assert kernel.top_placement(2048, "traverse") == "shared"
    assert kernel.top_placement(4096, "traverse") == "global"
    assert kernel.top_placement(4096) == "shared"
    assert kernel.top_placement(8192) == "global"
    for k, name in ((10, "range_step"), (10, "traverse"), (2048, "range_step"),
                    (5000, "traverse")):
        slots = kernel.shared_acc_slots(k, name)
        top = kernel.top_bytes(k, name) if kernel.top_placement(k, name) == "shared" else 0
        lists = kernel.CAND_CAP + kernel.TOUCHED_CAP
        assert 4 * (slots + lists) + top + kernel.STATIC_RESERVE <= 232_448
        assert kernel.acc_placement(slots, name, k) == "shared"
        assert kernel.acc_placement(slots + 1, name, k) == "global"
    assert kernel.acc_placement(9_984) == "shared"
    assert kernel.acc_placement(65_536) == "global"
    with pytest.raises(ValueError, match="kernel"):
        kernel.top_bytes(10, "scatter")


def test_state_layout_reads_theta_and_postings_in_one_view():
    k = 6
    st = ref.init_state(k)
    assert st.vals.tolist() == [0] * k and st.ids.tolist() == [-1] * k
    assert (int(st.postings), int(st.blocks)) == (0, 0)
    assert st.postings.data_ptr() == st.vals.data_ptr() + 4 * k
    buf = torch.arange(2 * k + 2, dtype=torch.int32)
    laid = ref.state_views(buf, k)
    assert ref.theta_postings(laid) == [k - 1, k]
    loose = ref.TopKState(vals=buf[:k].clone(), ids=buf[k + 2:].clone(),
                          postings=torch.tensor(99, dtype=torch.int32),
                          blocks=torch.tensor(1, dtype=torch.int32))
    assert ref.theta_postings(loose) == [k - 1, 99]
    assert range_daat.theta(laid) is not None and int(range_daat.theta(laid)) == k - 1
