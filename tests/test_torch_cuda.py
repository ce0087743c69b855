"""The port's CUDA kernels and engine on the card, against the plain path.

Every test here that needs the card is marked ``cuda`` and skips without
one: the kernels have no CPU mode. The file imports only the port, so it also runs where
JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest`` because ``tests/conftest.py`` builds the reference's
fixtures with the JAX package.) Kernel outputs must equal their plain
versions bitwise, and the kernels' engine must equal the plain engine on
every host-observable. The fused ``range_step`` kernel is held bitwise
against ``range_step_ref`` at both accumulator placements (shared memory
at ``s_pad`` 9,984, a global scratch at 65,536), and the ``traverse``
kernel (N lanes' whole-query loops) against ``traverse_ref`` on every
carry field, also over stacked range shards (lane n reads shard n % S),
with ``BatchEngine``, ``ShardedBatchEngine`` and ``InflightServer`` on
``cuda`` equal to ``torch``; engines loaded from index artifacts
(``from_artifact``) equal the in-memory ones on the card, and serving
with an enabled ``obs`` handle equals serving without. The bag
reduce sums
floats in another order than its plain version, so it is held within a
stated tolerance instead.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch import index_io
from repro_torch.core.clustered_index import (
    BLOCK, build_index, pack_dir_entries, pack_docs, shard_device_index)
from repro_torch.core.oracle import exhaustive_topk
from repro_torch.core.range_daat import DeviceIndex, Engine
from repro_torch.data.synth import make_corpus, make_query_log
from repro_torch.kernels.embedding_bag import kernel as bag_kernel
from repro_torch.kernels.embedding_bag.ref import bag_reduce_plain
from repro_torch.kernels.range_scorer import kernel, ref
from repro_torch.obs import NOOP, Instrumentation
from repro_torch.serving import (
    BatchEngine,
    BucketSpec,
    InflightServer,
    MicroBatchServer,
    ShardedBatchEngine,
    ShardedEngine,
    SlaBudgeter,
)
from repro_torch.models.embedding import (
    bag_inputs,
    combine_bags,
    embedding_bag,
    table_from_numpy,
)

CONFIGS = [(dt, fmt) for dt in ("int32", "int8") for fmt in ("int32", "packed")]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def small_index():
    corpus = make_corpus(n_docs=2500, n_terms=3000, n_topics=8, mean_doc_len=120,
                         seed=0)
    log = make_query_log(corpus, n_queries=12, seed=1)
    index = build_index(corpus, n_ranges=8, strategy="clustered", bits=8)
    return index, [log.terms[i] for i in range(log.n_queries)]


def _cuda(a, dev, dtype=None) -> torch.Tensor:
    a = np.ascontiguousarray(a if dtype is None else np.asarray(a).astype(dtype))
    return torch.from_numpy(a).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("s_pad,n_blocks", [(128, 1), (1024, 32), (20_096, 128)])
def test_scatter_accumulate_matches_plain(cuda_device, s_pad, n_blocks):
    rng = np.random.default_rng(s_pad + n_blocks)
    nnz = 50_000
    docs = np.sort(rng.integers(0, s_pad, size=nnz)).astype(np.int32)
    imps = rng.integers(1, 256, size=nnz).astype(np.int32)
    starts = rng.integers(0, nnz - BLOCK, size=n_blocks).astype(np.int32)
    lens = rng.integers(1, BLOCK + 1, size=n_blocks).astype(np.int32)
    keep = rng.random(n_blocks) < 0.8
    local, vals = ref.gather_block_postings(
        *(_cuda(a, cuda_device) for a in (docs, imps, starts, lens, keep)), 0
    )
    before = kernel.scatter_accumulate.launches
    got = kernel.scatter_accumulate(local, vals, s_pad)
    torch.cuda.synchronize()
    assert kernel.scatter_accumulate.launches == before + 1
    assert torch.equal(got, ref.scatter_accumulate_ref(local, vals, s_pad))


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 3, 9])
def test_unpack_locals_matches_plain(cuda_device, seed):
    rng = np.random.default_rng(seed)
    blk_len = rng.integers(1, BLOCK + 1, size=64).astype(np.int64)
    blk_start = np.cumsum(blk_len) - blk_len
    deltas = [rng.integers(0, int(rng.choice([1, 2, 200, 300, 70_000])), size=int(n))
              for n in blk_len]
    docs = np.concatenate([np.cumsum(d) for d in deltas])
    packed = pack_docs(docs, blk_start, blk_len)
    sel = rng.integers(0, 64, size=96)
    starts = blk_start[sel].astype(np.int32)
    starts[-2:] = -1  # padding rows
    args = (
        _cuda(np.asarray(packed.words, np.uint32).view(np.int32), cuda_device),
        _cuda(starts, cuda_device),
        _cuda(blk_len[sel], cuda_device, np.int32),
        _cuda(pack_dir_entries(packed)[sel], cuda_device, np.int32),
        _cuda(packed.blk_first[sel], cuda_device, np.int32),
        _cuda(rng.random(96) < 0.8, cuda_device),
        torch.tensor(7, dtype=torch.int32, device=cuda_device),
    )
    got = kernel.unpack_locals(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, ref.unpack_locals_ref(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("impact_dtype,docs_format", CONFIGS)
def test_cuda_engine_matches_plain_engine(cuda_device, small_index, impact_dtype,
                                          docs_format):
    index, queries = small_index
    kern = Engine(index, k=10, device=cuda_device, impact_dtype=impact_dtype,
                  docs_format=docs_format)
    plain = Engine(index, k=10, device="cpu", impact_dtype=impact_dtype,
                   docs_format=docs_format)
    assert (kern.impl, plain.impl) == ("cuda", "torch")
    for q in queries:
        for budget in (2**31 - 1, 300):
            a = kern.traverse(kern.plan(q), budget_postings=budget)
            b = plain.traverse(plain.plan(q), budget_postings=budget)
            assert [x.tolist() for x in kern.topk_docs(a.state)] == [
                x.tolist() for x in plain.topk_docs(b.state)]
            assert (int(a.state.postings), int(a.state.blocks), a.ranges_processed,
                    a.exit_safe, a.exit_budget) == (
                int(b.state.postings), int(b.state.blocks), b.ranges_processed,
                b.exit_safe, b.exit_budget)
        res = kern.traverse(kern.plan(q))
        _, vals = kern.topk_docs(res.state)
        # Safe exits match the oracle's scores; ids may differ among ties
        # at the k-th score, as in the reference.
        assert vals.tolist() == exhaustive_topk(index, q, 10)[1].tolist()


def _step_case(rng, dev, s_pad, impact_dtype, docs_format, k, theta, n_blocks=256):
    """A range-step input on ``dev``: a pool of blocks with sorted docids in
    one range of ``s_pad`` docs, ``n_blocks`` of them listed (the last few
    -1), and a state that is empty (``theta`` 0) or full with θ > 0."""
    n_pool, rs = 400, 1_000
    lens = rng.integers(1, BLOCK + 1, size=n_pool)
    lens[::7] = BLOCK
    starts = np.cumsum(lens) - lens
    docs = np.concatenate([np.sort(rng.choice(s_pad, size=int(n), replace=False))
                           for n in lens]).astype(np.int64) + rs
    imps = rng.integers(1, 256, size=docs.shape[0])
    imps[: docs.shape[0] // 3] = 9  # many equal sums
    maximp = np.array([imps[a:a + n].max() for a, n in zip(starts, lens)])
    stored = (imps - ref.IMPACT_BIAS).astype(np.int8) if impact_dtype == "int8" \
        else imps.astype(np.int32)
    cols = dict(docs=docs, impacts=stored, blk_start=starts, blk_len=lens,
                blk_maximp=maximp, bounds_dense=np.zeros((1, 1)),
                range_starts=np.array([rs]), range_sizes=np.array([s_pad]))
    if docs_format == "packed":
        packed = pack_docs(docs, starts, lens)
        cols.update(docs=np.zeros(1), pack_words=np.asarray(packed.words,
                                                            np.uint32).view(np.int32),
                    pack_dir=pack_dir_entries(packed), pack_first=packed.blk_first)
    dix = DeviceIndex(**{n: _cuda(a, dev, None if n == "impacts" else np.int32)
                         for n, a in cols.items()})
    blk = rng.choice(n_pool, size=n_blocks, replace=False).astype(np.int32)
    blk[-3:] = -1
    rest = rng.integers(0, 400, size=n_blocks).astype(np.int32)
    buf = np.zeros(2 * k + 2, np.int32)
    buf[k + 2:] = -1
    if theta:
        buf[:k] = np.sort(rng.integers(theta, theta + 200, size=k))[::-1]
        buf[k + 2:] = rng.choice(np.arange(rs + s_pad, rs + s_pad + 4 * k), size=k,
                                 replace=False)
        buf[k:k + 2] = (12_345, 67)
    state = ref.state_views(_cuda(buf, dev), k)
    return dix, state, _cuda(blk, dev), _cuda(rest, dev), torch.tensor(
        rs, dtype=torch.int32, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 10, 1024])
@pytest.mark.parametrize("s_pad", [9_984, 65_536])
def test_range_step_matches_plain(cuda_device, s_pad, k):
    """Both accumulator placements, θ = 0 and θ > 0, all four configurations."""
    assert kernel.acc_placement(s_pad) == ("shared" if s_pad == 9_984 else "global")
    rng = np.random.default_rng(s_pad + k)
    for impact_dtype, docs_format in CONFIGS:
        for theta in (0, 300):
            dix, state, blk, rest, rs = _step_case(rng, cuda_device, s_pad, impact_dtype,
                                                   docs_format, k, theta)
            for prune in (True, False):
                kw = dict(s_pad=s_pad, k=k, prune_blocks=prune, docs_format=docs_format)
                before = kernel.range_step.launches
                got = kernel.range_step(dix, state, blk, rest, rs, **kw)
                torch.cuda.synchronize()
                assert kernel.range_step.launches == before + 1
                want = ref.range_step_ref(dix, state, blk, rest, rs, **kw)
                ctx = f"{impact_dtype}/{docs_format} theta={theta} prune={prune}"
                for name, g, w in zip(ref.TopKState._fields, got, want):
                    assert torch.equal(g, w), f"{ctx}: {name}"
                assert got.postings.data_ptr() == got.vals.data_ptr() + 4 * k


@pytest.mark.cuda
def test_range_step_raises_above_its_k_limit(cuda_device):
    """The limit is the reference's, s_pad: range_step and traverse equal
    their plain versions at k = 1,025 and 2,048 (both accumulator
    placements), and k = 0 or k > s_pad raise."""
    for s_pad in (9_984, 65_536):
        for k in (1025, 2048):
            rng = np.random.default_rng(s_pad + k)
            for theta in (0, 300):
                dix, state, blk, rest, rs = _step_case(rng, cuda_device, s_pad, "int8",
                                                       "packed", k, theta)
                kw = dict(s_pad=s_pad, k=k, docs_format="packed")
                got = kernel.range_step(dix, state, blk, rest, rs, **kw)
                want = ref.range_step_ref(dix, state, blk, rest, rs, **kw)
                for name, g, w in zip(ref.TopKState._fields, got, want):
                    assert torch.equal(g, w), f"s_pad={s_pad} k={k} theta={theta}: {name}"
            dix, lanes = _traverse_case(rng, cuda_device, s_pad, "int32", "int32", k, 3)
            kw = dict(s_pad=s_pad, k=k)
            _assert_carry_equal(kernel.traverse(dix, *lanes, **kw),
                                ref.traverse_ref(dix, *lanes, **kw), k,
                                f"traverse s_pad={s_pad} k={k}")
    rng = np.random.default_rng(0)
    dix, _, blk, rest, rs = _step_case(rng, cuda_device, 256, "int32", "int32", 10, 0,
                                       n_blocks=8)
    for k in (0, 257):
        with pytest.raises(ValueError, match="1 <= k <= s_pad"):
            kernel.range_step(dix, ref.init_state(max(k, 1), cuda_device), blk, rest, rs,
                              s_pad=256, k=k)


def _with_state(state_args, vals, ids):
    """``_step_case``'s tuple with its state replaced by (vals, ids)."""
    dix, state, blk, rest, rs = state_args
    k = len(vals)
    buf = np.concatenate([np.asarray(vals), [12_345, 67], np.asarray(ids)])
    return dix, ref.state_views(_cuda(buf, rs.device, np.int32), k), blk, rest, rs


SELECTION_CASES = ["state tied at theta", "no slot above theta", "every slot survives",
                   "k above the nonzero slots", "global top-k scratch"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", SELECTION_CASES)
def test_range_step_selection_cases(cuda_device, case):
    """The filter, radix select and merge against the plain version at the
    selection's edges, in all four configurations, pruning on and off."""
    for ci, (impact_dtype, docs_format) in enumerate(CONFIGS):
        rng = np.random.default_rng(100 + ci)
        s_pad, n_blocks, ks = 9_984, 256, (10, 100)
        if case == "k above the nonzero slots":
            n_blocks, ks = 6, (1000, 9_984)  # at most 3 * 128 nonzero slots
        elif case == "every slot survives":
            ks = (1, 10, 32, 33, 1000, 9_984)
        elif case == "global top-k scratch":
            ks = (8192,)
            assert kernel.top_placement(8192) == "global"
        for k in ks:
            args = _step_case(rng, cuda_device, s_pad, impact_dtype, docs_format, k, 0,
                              n_blocks=n_blocks)
            ids = rng.choice(np.arange(20_000, 20_000 + 4 * k), size=k, replace=False)
            if case == "state tied at theta":
                # Sums of 9s are common: every state entry ties them at 18.
                args = _with_state(args, np.full(k, 18), np.sort(ids))
            elif case == "no slot above theta":
                args = _with_state(args, np.full(k, 1_000_000), np.sort(ids))
            elif case == "global top-k scratch":
                vals = np.sort(rng.choice([0, 18, 27, 300], size=k))[::-1]
                args = _with_state(args, vals, np.where(vals > 0, np.sort(ids), -1))
            for prune in (True, False):
                kw = dict(s_pad=s_pad, k=k, prune_blocks=prune, docs_format=docs_format)
                got = kernel.range_step(*args, **kw)
                want = ref.range_step_ref(*args, **kw)
                ctx = f"{case} {impact_dtype}/{docs_format} k={k} prune={prune}"
                for name, g, w in zip(ref.TopKState._fields, got, want):
                    assert torch.equal(g, w), f"{ctx}: {name}"


@pytest.mark.cuda
def test_traverse_global_top_scratch_and_quantum_chain(cuda_device):
    """traverse with its states and sort scratch in global memory (k = 4,096),
    and chained quanta ending where one run ends, against the plain version."""
    assert kernel.top_placement(4096, "traverse") == "global"
    for s_pad, k in ((9_984, 4096), (65_536, 4096), (9_984, 33)):
        rng = np.random.default_rng(s_pad + k)
        dix, lanes = _traverse_case(rng, cuda_device, s_pad, "int8", "packed", k, 5,
                                    ties=True)
        kw = dict(s_pad=s_pad, k=k, docs_format="packed")
        whole = kernel.traverse(dix, *lanes, **kw)
        _assert_carry_equal(whole, ref.traverse_ref(dix, *lanes, **kw), k,
                            f"s_pad={s_pad} k={k}")
        for quantum in (1, 2):
            carry = lanes[-1]
            for _ in range(8):
                carry = kernel.traverse(dix, *lanes[:-1], carry, quantum=quantum, **kw)
            _assert_carry_equal(carry, whole, k, f"s_pad={s_pad} k={k} chained {quantum}")


@pytest.mark.cuda
@pytest.mark.parametrize("docs_format", ["int32", "packed"])
def test_cuda_engine_launches_range_step_once_per_range(cuda_device, small_index,
                                                        docs_format):
    """The anytime loop's Engine.step launches range_step once per range;
    a whole-query Engine.traverse launches traverse once per query."""
    from repro_torch.core.anytime import run_query_anytime

    index, queries = small_index
    kern = Engine(index, k=10, device=cuda_device, impact_dtype="int8",
                  docs_format=docs_format)
    counts = (kernel.scatter_accumulate.launches, kernel.unpack_locals.launches)
    kernel.range_step.launches = kernel.traverse.launches = 0
    ranges = sum(run_query_anytime(kern, kern.plan(q)).ranges_processed for q in queries)
    assert kernel.range_step.launches == ranges > 0
    assert kernel.traverse.launches == 0
    kernel.range_step.launches = 0
    assert sum(kern.traverse(kern.plan(q)).ranges_processed for q in queries) == ranges
    assert (kernel.traverse.launches, kernel.range_step.launches) == (len(queries), 0)
    assert (kernel.scatter_accumulate.launches, kernel.unpack_locals.launches) == counts


def _traverse_case(rng, dev, s_pad, impact_dtype, docs_format, k, n_lanes, ties=False,
                   n_ranges=5, n_blocks=48):
    """``traverse`` inputs on ``dev``: R ranges of ``s_pad`` docs, each with a
    pool of blocks of sorted docids; per lane a random block table (-1
    padded), order and descending bounds; budgets and caps mixing
    unbounded, small and 0 (the last lane a dummy: budget 0, cap 0); and a
    carry that is fresh, or mid-flight with a full tie-heavy state (θ > 0),
    or parked. ``ties`` draws every impact from {3, 5}."""
    R, pool = n_ranges, 64
    docs, imps, starts, lens, pools = [], [], [], [], []
    off = 0
    for r in range(R):
        rs = 1_000 + r * s_pad
        ln = rng.integers(1, BLOCK + 1, size=pool)
        ln[::5] = BLOCK
        ids = []
        for n in ln:
            d = np.sort(rng.choice(s_pad, size=int(n), replace=False)) + rs
            docs.append(d)
            ids.append(len(starts))
            starts.append(off)
            lens.append(int(n))
            off += int(n)
        pools.append(ids)
    docs = np.concatenate(docs).astype(np.int64)
    imps = rng.choice([3, 5], size=off) if ties else rng.integers(1, 256, size=off)
    starts, lens = np.asarray(starts), np.asarray(lens)
    maximp = np.array([imps[a:a + n].max() for a, n in zip(starts, lens)])
    stored = (imps - ref.IMPACT_BIAS).astype(np.int8) if impact_dtype == "int8" \
        else imps.astype(np.int32)
    cols = dict(docs=docs, impacts=stored, blk_start=starts, blk_len=lens,
                blk_maximp=maximp, bounds_dense=np.zeros((1, 1)),
                range_starts=1_000 + np.arange(R) * s_pad,
                range_sizes=np.full(R, s_pad))
    if docs_format == "packed":
        packed = pack_docs(docs, starts, lens)
        cols.update(docs=np.zeros(1), pack_words=np.asarray(packed.words,
                                                            np.uint32).view(np.int32),
                    pack_dir=pack_dir_entries(packed), pack_first=packed.blk_first)
    dix = DeviceIndex(**{n: _cuda(a, dev, None if n == "impacts" else np.int32)
                         for n, a in cols.items()})
    N = n_lanes
    blk = np.full((N, R, n_blocks), -1, np.int32)
    for n in range(N):
        for r in range(R):
            m = int(rng.integers(0, n_blocks + 1))
            blk[n, r, :m] = rng.choice(pools[r], size=m, replace=False)
    rest = rng.integers(0, 400, size=(N, R, n_blocks)).astype(np.int32)
    order = np.stack([rng.permutation(R) for _ in range(N)]).astype(np.int32)
    bounds = -np.sort(-rng.integers(0, 2_500, size=(N, R)), axis=1).astype(np.int32)
    budget = rng.choice([0, 60, 700, 4_000, 2**31 - 1], size=N).astype(np.int32)
    maxr = rng.choice([0, 1, 3, R, 2**31 - 1], size=N).astype(np.int32)
    budget[:N // 2 + 1] = 2**31 - 1  # at least half the lanes run freely
    maxr[:N // 2 + 1] = 2**31 - 1
    budget[-1] = maxr[-1] = 0 if N > 1 else budget[-1]
    width = ref.carry_width(k)
    carry = np.zeros((N, width), np.int32)
    carry[:, k + 2:2 * k + 2] = -1
    for n in range(N):
        kind = n % 4
        if kind == 2:  # mid-flight, a full state tied at θ
            theta = int(rng.integers(20, 400))
            carry[n, :k] = np.sort(rng.choice([theta, theta, theta + 7, theta + 40],
                                              size=k))[::-1]
            carry[n, k + 2:2 * k + 2] = rng.choice(
                np.arange(1_000 + R * s_pad, 1_000 + R * s_pad + 4 * k), size=k,
                replace=False)
            carry[n, k:k + 2] = rng.integers(0, 3_000, size=2)
            carry[n, 2 * k + 2] = rng.integers(0, R)
        elif kind == 3 and n != N - 1:  # parked
            carry[n, 2 * k + 4] = 1
    lanes = [_cuda(a, dev) for a in (blk, rest, order, bounds, budget, maxr, carry)]
    return dix, lanes


def _assert_carry_equal(got, want, k, ctx):
    fields = (("vals", slice(0, k)), ("postings", k), ("blocks", k + 1),
              ("ids", slice(k + 2, 2 * k + 2)), ("i", 2 * k + 2),
              ("exit_safe", 2 * k + 3), ("exit_budget", 2 * k + 4))
    assert got.shape == want.shape and got.dtype == want.dtype == torch.int32, ctx
    for name, col in fields:
        assert torch.equal(got[:, col], want[:, col]), f"{ctx}: {name}"


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 10, 1024])
@pytest.mark.parametrize("s_pad", [9_984, 65_536])
def test_traverse_matches_plain(cuda_device, s_pad, k):
    """Every carry field of every lane, both placements, four configurations,
    quantum None and chained quanta."""
    assert kernel.acc_placement(s_pad, "traverse") == (
        "shared" if s_pad == 9_984 else "global")
    rng = np.random.default_rng(s_pad + 7 * k)
    for ci, (impact_dtype, docs_format) in enumerate(CONFIGS):
        n_lanes = (1, 5, 32)[ci % 3] if ci < 3 else 5
        dix, lanes = _traverse_case(rng, cuda_device, s_pad, impact_dtype, docs_format, k,
                                    n_lanes, ties=ci % 2 == 1)
        kw = dict(s_pad=s_pad, k=k, docs_format=docs_format)
        ctx = f"{impact_dtype}/{docs_format} N={n_lanes}"
        before = kernel.traverse.launches
        whole = kernel.traverse(dix, *lanes, **kw)
        torch.cuda.synchronize()
        assert kernel.traverse.launches == before + 1
        _assert_carry_equal(whole, ref.traverse_ref(dix, *lanes, **kw), k, ctx)
        for quantum in (1, 2, 3):
            carry = lanes[-1]
            first = kernel.traverse(dix, *lanes[:-1], carry, quantum=quantum, **kw)
            _assert_carry_equal(first, ref.traverse_ref(dix, *lanes[:-1], carry,
                                                        quantum=quantum, **kw),
                                k, f"{ctx} quantum={quantum}")
            carry = first
            for _ in range(6):
                carry = kernel.traverse(dix, *lanes[:-1], carry, quantum=quantum, **kw)
            _assert_carry_equal(carry, whole, k, f"{ctx} chained quantum={quantum}")


@pytest.mark.cuda
def test_traverse_accumulator_limit_both_sides(cuda_device):
    """The last shared-memory s_pad and the first global one, at k = 10."""
    last = kernel.shared_acc_slots(10, "traverse") // BLOCK * BLOCK
    assert [kernel.acc_placement(s, "traverse") for s in (last, last + BLOCK)] == [
        "shared", "global"]
    for s_pad in (last, last + BLOCK):
        rng = np.random.default_rng(s_pad)
        dix, lanes = _traverse_case(rng, cuda_device, s_pad, "int8", "packed", 10, 3)
        kw = dict(s_pad=s_pad, k=10, docs_format="packed")
        _assert_carry_equal(kernel.traverse(dix, *lanes, **kw),
                            ref.traverse_ref(dix, *lanes, **kw), 10, f"s_pad={s_pad}")


@pytest.mark.cuda
@pytest.mark.parametrize("impact_dtype,docs_format", CONFIGS)
def test_cuda_batch_engine_matches_plain(cuda_device, small_index, impact_dtype,
                                         docs_format):
    """BatchEngine on cuda == on torch == Engine.traverse, one launch a chunk."""
    index, queries = small_index
    kern = Engine(index, k=10, device=cuda_device, impact_dtype=impact_dtype,
                  docs_format=docs_format)
    plain = Engine(index, k=10, device=cuda_device, impl="torch",
                   impact_dtype=impact_dtype, docs_format=docs_format)
    kb, pb = (BatchEngine(e, BucketSpec(max_batch=4)) for e in (kern, plain))
    plans = kb.plan_many(queries)
    rng = np.random.default_rng(0)
    for kw in ({}, dict(budget_postings=rng.choice([0, 300, 2**31 - 1], len(plans))),
               dict(max_ranges=rng.choice([0, 1, 3, 2**31 - 1], len(plans)))):
        before = (kernel.traverse.launches, kernel.range_step.launches)
        got = kb.run_batch(plans, **kw)
        assert kernel.traverse.launches - before[0] == kb.batches_run - pb.batches_run
        assert kernel.range_step.launches == before[1]
        want = pb.run_batch(plans, **kw)
        for i, (g, w) in enumerate(zip(got, want)):
            assert g.doc_ids.tolist() == w.doc_ids.tolist(), i
            assert g.scores.tolist() == w.scores.tolist(), i
            assert g[2:] == w[2:], i
            b = kw.get("budget_postings", [2**31 - 1] * len(plans))[i]
            m = kw.get("max_ranges", [2**31 - 1] * len(plans))[i]
            one = kern.traverse(plans[i], budget_postings=int(b), max_ranges=int(m))
            ids, vals = kern.topk_docs(one.state)
            assert (ids.tolist(), vals.tolist(), one.ranges_processed,
                    int(one.state.postings), int(one.state.blocks), one.exit_safe,
                    one.exit_budget) == (g.doc_ids.tolist(), g.scores.tolist(),
                                         g.ranges_processed, g.postings, g.blocks,
                                         g.exit_safe, g.exit_budget), i


def _stack_rows(cols, pad=0):
    """[S, W] from S 1-D arrays, each row padded to the widest."""
    w = max(max(len(c) for c in cols), 1)
    out = np.full((len(cols), w), pad, cols[0].dtype)
    for i, c in enumerate(cols):
        out[i, :len(c)] = c
    return out


def _stacked_case(rng, dev, s_pad, impact_dtype, docs_format, k, n_queries, n_shards,
                  clamp=True):
    """``traverse`` inputs over S stacked shards of unequal size: shard s
    has R_max - s ranges (its padded order slots point at an all -1 row
    with zero bounds), lane q * S + s reads shard s. With ``clamp`` the
    widest shard's last block is stretched to 128 postings past its row's
    end and listed first in its range for every lane of that shard, so
    its gathers reach the clamp at the row's end."""
    R = n_shards + 2
    shards = [_traverse_case(rng, "cpu", s_pad, impact_dtype, docs_format, k,
                             n_queries, n_ranges=R - s) for s in range(n_shards)]
    names = [n for n in shards[0][0]._fields if getattr(shards[0][0], n) is not None]
    cols = {n: [getattr(d, n).numpy() for d, _ in shards] for n in names}
    if clamp:
        last = len(cols["blk_len"][0]) - 1
        cols["blk_len"][0] = cols["blk_len"][0].copy()
        cols["blk_len"][0][last] = BLOCK
    cols = {n: _stack_rows(c) for n, c in cols.items()}
    cols["bounds_dense"] = np.zeros((n_shards, 1, 1), np.int32)
    dix = DeviceIndex(**{n: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                         for n, a in cols.items()})
    N, nb = n_queries * n_shards, shards[0][1][0].shape[2]
    blk = np.full((N, R, nb), -1, np.int32)
    rest = np.zeros((N, R, nb), np.int32)
    order = np.zeros((N, R), np.int32)
    bounds = np.zeros((N, R), np.int32)
    caps = np.zeros((2, N), np.int32)
    carry = np.zeros((N, ref.carry_width(k)), np.int32)
    for s, (_, lanes) in enumerate(shards):
        b, r, o, bd, bud, mr, c = (x.numpy() for x in lanes)
        rs = R - s
        lane = np.arange(n_queries) * n_shards + s
        blk[lane, :rs], rest[lane, :rs] = b, r
        order[lane, :rs], bounds[lane, :rs] = o, bd
        order[lane, rs:] = rs if rs < R else 0
        caps[:, lane] = bud, mr
        carry[lane] = c
        if clamp and s == 0:
            blk[lane, R - 1, 0] = last
    return dix, [_cuda(a, dev) for a in (blk, rest, order, bounds, caps[0], caps[1],
                                         carry)]


@pytest.mark.cuda
@pytest.mark.parametrize("s_pad,k", [(9_984, 10), (65_536, 1), (9_984, 1024)])
def test_traverse_over_stacked_shards_matches_plain(cuda_device, s_pad, k):
    """Every carry field of every (query, shard) lane: unequal shard rows,
    padded range slots, the clamp at a row's end; quantum chains over the
    stacked lanes end where one run ends; one launch per call."""
    rng = np.random.default_rng(s_pad + k)
    for ci, (impact_dtype, docs_format) in enumerate(CONFIGS):
        n_shards = (2, 3, 4, 2)[ci]
        dix, lanes = _stacked_case(rng, cuda_device, s_pad, impact_dtype, docs_format, k,
                                   n_queries=3, n_shards=n_shards)
        kw = dict(s_pad=s_pad, k=k, docs_format=docs_format)
        ctx = f"{impact_dtype}/{docs_format} S={n_shards}"
        before = kernel.traverse.launches
        whole = kernel.traverse(dix, *lanes, **kw)
        torch.cuda.synchronize()
        assert kernel.traverse.launches == before + 1
        _assert_carry_equal(whole, ref.traverse_ref(dix, *lanes, **kw), k, ctx)
        for quantum in (1, 2, 3):
            carry = kernel.traverse(dix, *lanes, quantum=quantum, **kw)
            _assert_carry_equal(carry, ref.traverse_ref(dix, *lanes, quantum=quantum,
                                                        **kw), k, f"{ctx} q={quantum}")
            for _ in range(8):
                carry = kernel.traverse(dix, *lanes[:-1], carry, quantum=quantum, **kw)
            _assert_carry_equal(carry, whole, k, f"{ctx} chained quantum={quantum}")


@pytest.mark.cuda
@pytest.mark.parametrize("impact_dtype,docs_format", CONFIGS)
def test_traverse_one_stacked_shard_equals_unstacked(cuda_device, impact_dtype,
                                                     docs_format):
    rng = np.random.default_rng(11)
    dix, lanes = _stacked_case(rng, cuda_device, 9_984, impact_dtype, docs_format, 10,
                               n_queries=5, n_shards=1, clamp=False)
    flat = DeviceIndex(*(None if t is None else t[0].contiguous() for t in dix))
    kw = dict(s_pad=9_984, k=10, docs_format=docs_format)
    for quantum in (None, 2):
        _assert_carry_equal(kernel.traverse(dix, *lanes, quantum=quantum, **kw),
                            kernel.traverse(flat, *lanes, quantum=quantum, **kw), 10,
                            f"{impact_dtype}/{docs_format} quantum={quantum}")


@pytest.mark.cuda
@pytest.mark.parametrize("n_shards", [2, 4])
def test_cuda_sharded_batch_engine_matches_plain(cuda_device, small_index, n_shards):
    """ShardedBatchEngine on cuda == on torch on every ShardedResult field,
    one launch a chunk; the merged top-k == Engine.traverse's (safe_stop
    off: bitwise)."""
    index, queries = small_index
    kern = Engine(index, k=10, device=cuda_device, impact_dtype="int8",
                  docs_format="packed")
    plain = Engine(index, k=10, device=cuda_device, impl="torch", impact_dtype="int8",
                   docs_format="packed")
    kb, pb = (ShardedBatchEngine(ShardedEngine(e, n_shards), BucketSpec(max_batch=4))
              for e in (kern, plain))
    plans = kb.plan_many(queries)
    down = np.zeros(n_shards, bool)
    down[0] = True
    for kw in ({}, dict(budget_postings=900), dict(max_ranges=3),
               dict(down_mask=down), dict(safe_stop=False)):
        before = (kernel.traverse.launches, kernel.range_step.launches)
        got = kb.run_batch(plans, **kw)
        assert kernel.traverse.launches - before[0] == kb.batches_run - pb.batches_run
        assert kernel.range_step.launches == before[1]
        want = pb.run_batch(plans, **kw)
        for i, (g, w) in enumerate(zip(got, want)):
            for name in w._fields:
                a, b = getattr(g, name), getattr(w, name)
                assert (a.tolist() == b.tolist()) if isinstance(b, np.ndarray) else a == b, (
                    kw, i, name)
            if kw.get("safe_stop") is False:
                ids, vals = kern.topk_docs(kern.traverse(plans[i], safe_stop=False).state)
                assert (g.doc_ids.tolist(), g.scores.tolist()) == (ids.tolist(),
                                                                   vals.tolist()), i


@pytest.mark.cuda
@pytest.mark.parametrize("quantum", [1, 3])
def test_cuda_inflight_server_matches_plain(cuda_device, small_index, quantum):
    """InflightServer on cuda == on torch, and each query == Engine.traverse;
    exactly one traverse launch per step."""
    index, queries = small_index
    kern = Engine(index, k=10, device=cuda_device, docs_format="packed")
    plain = Engine(index, k=10, device=cuda_device, impl="torch", docs_format="packed")
    runs = []
    for eng in (kern, plain):
        srv = InflightServer(BatchEngine(eng), SlaBudgeter(sla_ms=float("inf")),
                             n_slots=4, quantum=quantum)
        before = (kernel.traverse.launches, kernel.range_step.launches)
        served = sorted(srv.replay(queries), key=lambda s: s.rid)
        runs.append((served, kernel.traverse.launches - before[0],
                     kernel.range_step.launches - before[1], srv.steps_run))
    (got, launches, steps_rs, steps), (want, plain_launches, _, plain_steps) = runs
    assert launches == steps == plain_steps and plain_launches == 0 and steps_rs == 0
    for g, w in zip(got, want):
        assert (g.rid, g.quanta) == (w.rid, w.quanta)
        assert g.result.doc_ids.tolist() == w.result.doc_ids.tolist()
        assert g.result.scores.tolist() == w.result.scores.tolist()
        assert g.result[2:] == w.result[2:]
        one = kern.traverse(kern.plan(queries[g.rid]))
        ids, vals = kern.topk_docs(one.state)
        assert (ids.tolist(), vals.tolist(), one.ranges_processed, one.exit_safe) == (
            g.result.doc_ids.tolist(), g.result.scores.tolist(),
            g.result.ranges_processed, g.result.exit_safe)


# The bag reduce sums L terms in ascending order; the plain version's einsum
# (a batched matmul, TF32 off) uses another order. bfloat16 rounds once at
# the end on both sides: the JAX test's tolerance.
BAG_TOL = {torch.float32: dict(rtol=1e-5, atol=1e-4),
           torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}
BAG_SHAPES = [(4, 3, 8), (17, 20, 32), (128, 200, 64), (33, 7, 130),
              (512, 50, 64)]  # the last: MIND serve_p99


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,D", BAG_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bag_reduce_matches_plain(cuda_device, B, L, D, dtype):
    assert not torch.backends.cuda.matmul.allow_tf32
    rng = np.random.default_rng(B * 1000 + L)
    rows = _cuda(rng.normal(0, 1, size=(B, L, D)), cuda_device, np.float32).to(dtype)
    w = _cuda(rng.normal(0, 1, size=(B, L)), cuda_device, np.float32).to(dtype)
    before = bag_kernel.bag_reduce.launches
    got = bag_kernel.bag_reduce(rows, w)
    torch.cuda.synchronize()
    assert bag_kernel.bag_reduce.launches == before + 1
    assert got.dtype == dtype and tuple(got.shape) == (B, D)
    torch.testing.assert_close(got, bag_reduce_plain(rows, w), **BAG_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,D", [(0, 5, 8), (3, 0, 8), (3, 5, 0)])
def test_bag_reduce_empty_shapes_on_card(cuda_device, B, L, D):
    got = bag_kernel.bag_reduce(torch.ones(B, L, D, device=cuda_device),
                                torch.ones(B, L, device=cuda_device))
    torch.cuda.synchronize()
    assert tuple(got.shape) == (B, D)
    assert torch.equal(got.cpu(), torch.zeros(B, D))


@pytest.mark.cuda
@pytest.mark.parametrize("combine", ["sum", "mean"])
@pytest.mark.parametrize("weighted", [False, True])
def test_embedding_bag_on_card_matches_plain(cuda_device, combine, weighted):
    rng = np.random.default_rng(1)
    table = table_from_numpy(rng.normal(size=(1000, 64)).astype(np.float32))
    ids = rng.integers(0, 1010, size=(512, 50)).astype(np.int32)  # some >= V
    ids[:, 40:] = -1
    ids, w = _cuda(ids, cuda_device), _cuda(rng.normal(size=(512, 50)), cuda_device,
                                            np.float32)
    weights = w if weighted else None
    before = bag_kernel.bag_reduce.launches
    got = embedding_bag(table, ids, weights, combine)
    rows, wm = bag_inputs(table, ids, weights)
    want = combine_bags(bag_reduce_plain(rows, wm), wm, combine)
    torch.cuda.synchronize()
    assert bag_kernel.bag_reduce.launches == before + 1
    torch.testing.assert_close(got, want, **BAG_TOL[torch.float32])


@pytest.mark.cuda
def test_bag_reduce_wrapper_raises_on_card(cuda_device):
    rows = torch.ones(4, 3, 8, device=cuda_device)
    w = torch.ones(4, 3, device=cuda_device)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        bag_kernel.bag_reduce(rows.half(), w.half())
    with pytest.raises(TypeError, match="rows are"):
        bag_kernel.bag_reduce(rows, w.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        bag_kernel.bag_reduce(rows.transpose(0, 1).contiguous().transpose(0, 1), w)
    with pytest.raises(ValueError, match="contiguous"):
        bag_kernel.bag_reduce(rows, torch.ones(3, 4, device=cuda_device).t())
    with pytest.raises(ValueError, match="w is on"):
        bag_kernel.bag_reduce(rows, w.cpu())
    with pytest.raises(ValueError, match="w is on"):
        bag_kernel.bag_reduce(rows.cpu(), w)
    with pytest.raises(ValueError, match="ids are on"):
        embedding_bag(rows[0], torch.zeros(2, 3, dtype=torch.int32))


def test_embedding_bag_without_card_raises_and_names_cpu(monkeypatch):
    """The lookup's tables default to the card; without one, the CPU is named."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    table = np.ones((10, 4), np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        embedding_bag(table_from_numpy(table), torch.zeros(2, 3, dtype=torch.int32))
    out = embedding_bag(table_from_numpy(table, device="cpu"),
                        torch.zeros(2, 3, dtype=torch.int32))
    assert out.device.type == "cpu" and out.tolist() == [[3.0] * 4] * 2


def _fields(r) -> list:
    return [np.asarray(v).tolist() if isinstance(v, np.ndarray) else v for v in r]


@pytest.mark.cuda
@pytest.mark.parametrize("impact_dtype,docs_format", [("int8", "packed"),
                                                       ("int32", "int32")])
def test_from_artifact_on_card_matches_in_memory(cuda_device, small_index, tmp_path,
                                                  impact_dtype, docs_format):
    """The three engines from saved artifacts on the card equal the
    in-memory engines on the card, on every field, unbudgeted and budgeted."""
    index, queries = small_index
    path, spath = str(tmp_path / "idx"), str(tmp_path / "idx.shards")
    index_io.save_index(index, path, impact_dtype=impact_dtype, docs_format=docs_format)
    index_io.save_shards(shard_device_index(index, 2), spath, impact_dtype=impact_dtype,
                         quantizer=index.quantizer, source_fingerprint=index.fingerprint())
    mem = Engine(index, k=10, device=cuda_device, impact_dtype=impact_dtype,
                 docs_format=docs_format)
    eng = Engine.from_artifact(path, k=10, device=cuda_device)
    assert (eng.impl, eng.impact_dtype, eng.docs_format) == ("cuda", impact_dtype,
                                                             docs_format)
    plans = [mem.plan(q) for q in queries]
    for p in plans:
        for budget in (2**31 - 1, 300):
            a, b = eng.traverse(p, budget_postings=budget), mem.traverse(p, budget_postings=budget)
            assert (eng.topk_docs(a.state)[0].tolist(), a.ranges_processed, a.exit_safe,
                    a.exit_budget, int(a.state.postings)) == (
                mem.topk_docs(b.state)[0].tolist(), b.ranges_processed, b.exit_safe,
                b.exit_budget, int(b.state.postings))
    beng = BatchEngine.from_artifact(path, BucketSpec(max_batch=4), k=10, device=cuda_device)
    got = beng.run_batch(plans, budget_postings=300)
    want = BatchEngine(mem, BucketSpec(max_batch=4)).run_batch(plans, budget_postings=300)
    assert [_fields(g) for g in got] == [_fields(w) for w in want]
    seng = ShardedEngine.from_artifact(path, 2, shards_path=spath, k=10, device=cuda_device)
    sref = ShardedEngine(mem, 2)
    for p in plans:
        assert _fields(seng.traverse(p, 400)) == _fields(sref.traverse(p, 400))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["micro", "inflight", "sharded"])
def test_obs_on_equals_obs_off_on_card(cuda_device, small_index, mode):
    """Serving with an enabled handle (trace sample 1.0, profiler on) on the
    card equals serving with NOOP, and the profiler reads device time."""
    index, queries = small_index
    eng = Engine(index, k=10, device=cuda_device, impact_dtype="int8",
                 docs_format="packed")

    def serve(obs):
        if mode == "sharded":
            beng = ShardedBatchEngine(ShardedEngine(eng, 2, obs=obs), BucketSpec(max_batch=4))
        else:
            beng = BatchEngine(eng, BucketSpec(max_batch=4), obs=obs)
        bud = SlaBudgeter(sla_ms=float("inf"), obs=obs)
        bud.budgets = lambda n, plans=None: np.full(n, 500, np.int32)
        if mode == "inflight":
            srv = InflightServer(beng, bud, n_slots=4, quantum=2, obs=obs)
            served = srv.replay(queries)
        else:
            served = MicroBatchServer(beng, bud, max_batch=4, obs=obs).replay(queries)
        return [(s.rid, s.quanta, _fields(s.result))
                for s in sorted(served, key=lambda s: s.rid)]

    obs = Instrumentation.make(sample_rate=1.0, profile=True)
    assert serve(obs) == serve(NOOP)
    snap = next(iter(obs.profiler.snapshot().values()))
    assert snap["recompiles"] == 0 and snap["device_ms"] > 0.0
