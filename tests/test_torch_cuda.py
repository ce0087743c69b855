"""The port's CUDA kernels and engine on the card, against the plain path.

Every test here is marked ``cuda`` and skips without a card: the kernels
have no CPU mode. The file imports only the port, so it also runs where
JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest`` because ``tests/conftest.py`` builds the reference's
fixtures with the JAX package.) Kernel outputs must equal their plain
versions bitwise, and the kernels' engine must equal the plain engine on
every host-observable.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.core.clustered_index import BLOCK, build_index, pack_dir_entries, pack_docs
from repro_torch.core.oracle import exhaustive_topk
from repro_torch.core.range_daat import Engine
from repro_torch.data.synth import make_corpus, make_query_log
from repro_torch.kernels.range_scorer import kernel, ref

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
