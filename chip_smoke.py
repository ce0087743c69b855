#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py            # the whole smoke
    python3 chip_smoke.py --phases   # the range step's phase timer alone
    python3 chip_smoke.py --train    # the train phase alone
    python3 chip_smoke.py --mesh-model  # the model mesh phase alone
    python3 chip_smoke.py --dryrun   # the dry run's whole sweep and the roofline

Drives the port (``src/repro_torch``) through its main path on the card and
fails (non-zero exit, no result line) on any fault:

  1. builds the kernel libraries from ``csrc/range_scorer.cu`` and
     ``csrc/embedding_bag.cu`` with ``nvcc`` for ``sm_90a``, both at once,
     and prints each build's time and, per kernel, its variants'
     registers, shared memory and spills (``-Xptxas -v``; every variant's
     line goes to the JSON record);
  2. kernel phase — each range-scorer kernel against its plain PyTorch
     version on the card, bitwise: the standalone scatter and decode over
     the CPU tests' cases and main-path shapes, the fused range step
     (``range_step``) at both accumulator placements (shared memory at
     ``s_pad`` 9,984, a global scratch at 65,536), k 1, 10, 1,000, 1,025
     and 2,048 and k = ``s_pad`` at ``s_pad`` 256 (the top-k scratch then
     in global memory), ties at the k-th score, θ = 0 and θ > 0, four
     configurations, pruning on and off, and k = 0 and k > ``s_pad``
     refused; then the
     device-side loop (``traverse``) against ``traverse_ref`` on every
     carry field of every lane: both placements, the same k, N 1/5/32
     lanes with dummy and parked lanes and tie-heavy mid-flight states,
     four configurations, quantum None/1/2/3 with every chained run equal
     to the uninterrupted one; and ``traverse`` over stacked range shards
     (lane n reads shard n % S, S 2/3/4, unequal shard rows, padded range
     slots, a block stretched past its row's end to reach the clamp),
     every carry field, chained quanta equal to one run;
  3. preset phase — the benchmark preset (24,000 docs, ``clustered_bp``),
     200 queries: four engines on the card, int32/int8 impacts ×
     int32/packed docids, each equal to the plain path (``impl="torch"``)
     on the card and to the numpy oracle on safe exits (up to ties at the
     k-th score, as the reference's own tests allow), with one
     ``traverse`` launch per whole-query traversal and no ``range_step``,
     scatter or decode launch; then the anytime loop (``Engine.step``)
     on every query, run to its end and under ``Fixed`` caps, kernel
     engine equal to plain and to the whole-query traversal, with one
     ``range_step`` launch per range and nothing else; the telemetry
     parity: the four serving modes (host, batch, in-flight, sharded) on
     64 queries with an ``Instrumentation`` (trace sample 1.0, profiler
     on) and with ``NOOP``, every served field equal, the exit reasons the
     counters hold equal to the results', no recompile, and the
     synchronizing CUDA operations per dispatch with ``obs`` off and on
     (``torch.cuda.set_sync_debug_mode("warn")``); the delta chain at the
     preset's size (built in a worker: a ``clustered`` base artifact, one
     ``append_index`` of 2,400 documents, its ``compact``, and a fresh
     build of ``concat_corpora``): chain head (``load_chain``), compaction
     and fresh build served on the card equal on every ``observe_query``
     field for 64 queries, unbudgeted and budgeted; over the chain's base
     and head, a control plane journals a reshard and a shard down, and a
     fresh ``ControlPlane.from_artifact(..., replay=True)`` has the same
     cuts and ledger and answers 64 queries equally; the partitioned IR
     (``serve/distributed_ir.py``: the preset corpus split round-robin
     into 4 sub-indexes of 8 ranges, built in a worker): 64 queries x 4
     shards in one ``traverse`` launch, equal to its plain version on the
     card (values, global ids, ranges; unbudgeted and budgeted) and to the
     merged per-shard oracles; anytime MIPS (``serve/retrieval.py``) over
     1,000,000 candidates of width 64 in 64 ranges (built in a worker): the
     card against the CPU port on safe, budgeted and multi-interest
     queries (counters exact, scores within 1e-5), ms per query; the
     ``anytime-ir`` architecture through the registry
     (``ARCHS["anytime-ir"].build_step``, both shapes) over the same
     partitioned index, equal to ``sharded_anytime_query`` at the shape's
     budget bitwise, one ``traverse`` a step; then the arch phase: the five
     reduced LM configs (``prefill_32k`` and ``decode_32k``, both variants)
     and the four reduced towers (three shapes) on the card equal to the CPU
     port with the same weights (float32, TF32 off, rtol 1e-4, atol 1e-5,
     every MoE call's ``topi`` exact); qwen3-4b whole and deepseek-v3-671b
     at published widths with its depth cut to one dense and one MoE layer
     (bfloat16): ``prefill_32k`` at batch 1 x 32,768 (tokens/s, each
     expert's share of the routed slots and the capacity drops),
     ``decode_32k`` against a 32,768-slot cache (ms a step), a decoded token
     against an uncached ``lm_forward`` over the same tokens (relative L2
     within 5e-2), peak device memory; BST, MIND, AutoInt and BERT4Rec at
     their published configs at ``serve_p99`` (512), ``serve_bulk``
     (262,144) and ``retrieval_cand`` (1,000,000 candidates), ms a batch and
     examples/s; MIND's retrieval top-10 against anytime MIPS's safe top-10
     over the same rows and interests (k-means in a worker), the ranges its
     safe exit skipped;
     then the train phase: (a) every ``train`` shape of the registry at
     its reduced config (five LMs' ``train_4k``, four towers'
     ``train_batch``, GraphSAGE's four shapes, through
     ``Arch.build_step``) and deepseek-v3's LM at fp32, bf16 and int8
     moments, 3 steps on the card against the CPU port from the same
     weights and batches (float32, TF32 off: loss, lr and grad_norm
     within rtol 1e-4 / atol 1e-5, the parameters likewise but for
     gradient-noise elements, MoE ``topi`` exact at step 1); (b)
     qwen3-4b whole at published widths (bfloat16, fp32 moments, remat)
     through ``Trainer`` at ``train_4k`` 1 x 4,096: the loss of each of
     2 + 4 steps, s a step, tokens/s, peak memory (``--train`` also
     saves its 44 GB state through ``Checkpointer`` and restores it,
     bytes and seconds); (c) resume and preemption through
     ``Checkpointer`` at the reduced qwen3-4b with bf16 moments; (d)
     GraphSAGE's four shapes at published sizes (graphs built in worker
     processes, ``ogb_products`` 2,449,029 nodes and 61,860,352 edges)
     and the four towers' ``train_batch`` at published configs (MIND
     and BERT4Rec at cut batches, the cuts and reasons printed): ms a
     step, losses, peak memory;
  4. scale phase (its index through ``build_index_cached`` under
     ``.cache/``, hit or miss printed, a hit checked with
     ``validate_artifact``) — 250,000 docs, 50,000 terms, ``clustered``, 32 ranges:
     the same parity, the plain path on the first 96 queries (the oracle
     on all), the anytime loop on the first 48; the
     standalone kernels' own path
     (``ops.score_blocks(impl="cuda")`` on each query's first range, both
     docid formats, against its plain version); batch parity
     (``BatchEngine`` on cuda == on torch == ``Engine.traverse`` per
     query, 200 queries at ``max_batch`` 32 (torch on the first 96),
     unbudgeted, budgeted and
     range-capped, one ``traverse`` per chunk); ``Engine(k=2048)`` on cuda
     equal to ``impl="torch"`` on every ``observe_query`` field for 16
     queries, unbudgeted and budgeted; the serving loop of
     ``launch/serve.py`` (Reactive policy, SLA = 25% of the exhaustive
     P99: one ``range_step`` per range of the anytime loop, one
     ``traverse`` per warm-up traversal); the batch serving window of
     ``launch/serve.py --mode batch`` (``MicroBatchServer`` at batch 16:
     one ``traverse`` per dispatch); in-flight parity (``InflightServer``
     on cuda at 16 slots, quantum 1 and 3, unbudgeted and two fixed
     budgets, each served query equal to ``Engine.traverse``; 64 queries
     at quantum 2 equal to the plain server; one ``traverse`` per step);
     sharded parity (S = 2 and 4: ``ShardedBatchEngine`` on cuda at
     ``max_batch`` 16 equal to the plain sharded path on every
     ``ShardedResult`` field for 32 queries, unbudgeted, budgeted and one
     shard down; the merged top-k equal to ``Engine.traverse``, bitwise
     when both run exhaustively (no safe stop, no block pruning) and up
     to ties at the k-th score under safe stop and pruning;
     one ``traverse`` per chunk); the serving windows of ``--mode
     inflight`` (16 slots, quantum 1) and ``--mode sharded`` (S = 4,
     batch 16); the control plane (``ControlPlane(engine, 4, n_replicas=2)``
     at batch 16 on the one card: 64 queries equal to
     ``ShardedBatchEngine(ShardedEngine(engine, 4))`` and to the plane on
     the plain path; shard 1 down, equal to the plain plane, every query
     reaching shard 1 inexact; recovered, equal again; a live reshard with
     ``drain_once`` at 16 queued queries a drain, each stage's wall, the
     longest drain, queries served mid-cutover and arm to cutover, beside
     the same layout stop-the-world, then 64 queries equal to a fresh
     ``ShardedEngine`` at the new cuts; the plane's window against the
     sharded window over the same engine in turns, q/s, P99, miss);
     each window with the launch counters reset just before and read
     just after; the batch and in-flight windows again with an
     enabled ``obs`` (q/s and P99 beside the ``obs``-off windows, the
     obs profiler's plan/dispatch/device/transfer split beside the smoke's
     own split of the profiled windows below); the artifact phase
     (``save_index`` int8/packed and ``save_shards`` S = 4 with their
     bytes on disk against ``device_bytes_report``, ``load_index`` eager
     and mmap, the ``DeviceIndex`` upload, the cold start from
     ``Engine.from_artifact`` to the first answer; ``Engine.from_artifact``,
     an engine over the mmap load, ``BatchEngine.from_artifact`` and
     ``ShardedEngine.from_artifact(shards_path=...)`` equal to the
     in-memory engines for 64 queries, unbudgeted and budgeted, with one
     ``range_step`` per range of the anytime loop and one ``traverse`` per
     query or chunk; stale and unverifiable shard artifacts refused;
     ``repack`` int32 -> packed keeping fingerprint and results); the mesh
     phase (``torch.distributed`` ranks spawned here after the kernel
     build, sharing the card through gloo: four ranks each loading its own
     shard of that shard artifact, ``ShardedBatchEngine`` over the mesh for
     64 queries unbudgeted, budgeted and with shard 1 starved, equal on
     every ``ShardedResult`` field to the stacked engine on the card, one
     ``traverse`` per rank and dispatch; ``ControlPlane(n_replicas=2)`` on
     the 2 x 2 (data x shard) mesh over the preset, healthy, a batch of 3,
     shard 1 down and up and a live reshard, equal to one replica; the
     partitioned IR on a 2 x 4 context, 8 ranks, equal to one device; a
     one-rank NCCL mesh; the backend, devices, wall times, the per-dispatch
     split between the local ``traverse`` and the gather and merge, and
     whether gloo takes card tensors); then a
     profiled serving window that splits a
     query's time between the device and the host (plan time per query
     apart), a profiled batch window (plan, dispatch, device and read ms
     per batch, device idle share), a profiled in-flight window (upload,
     dispatch, device, plan and read ms per step, host-to-device copies
     per step, idle share), a profiled sharded window (plan, shard-plan,
     dispatch, device and read ms per batch, idle share), the phase
     timer (the kernels' timed variant: thread 0's ``clock64`` at each
     phase boundary of the range step, ``range_step`` warm and with L2
     flushed, ``traverse`` at 16 and 16 x 4 lanes, cycles turned into µs at
     the SM clock ``nvidia-smi`` reads beside it, and the step's
     dependency floor), and each
     kernel's time at main-path shapes beside its bound, its plain
     version and, for the scatter, ``Tensor.index_add_`` (CUDA events
     around many calls, launch gaps included, and device-only time from
     ``torch.profiler``), ``traverse`` also at the sharded shape (16
     queries x 4 shards);
  5. bag phase — the bag-reduce kernel against its plain version on the
     card, float32 and bfloat16, over the CPU tests' shapes, then the
     EmbeddingBag lookup (``models/embedding.py``) at the recsys
     configurations' published widths (MIND and BERT4Rec tables, serve
     batches of 512 and 262,144), weighted and unweighted, sum and mean,
     with its launch counter reset just before and read just after; then
     the kernel's time at each full-width shape beside its bound, its
     plain version, ``torch.bmm`` (the same reduction) and
     ``F.embedding_bag`` (the whole lookup). It runs last: run before the
     serving loop, its profiler windows slowed the loop's host time per
     range (see ``PERF.md``).

Both host index builds are numpy and run in worker processes while the
card works on the earlier phases. The last two lines of standard output
are the kernel report and the device line, each one JSON object; the card
name and power limit as ``nvidia-smi`` reports them come just before. A
copy of every number goes to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import functools
import json
import multiprocessing
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
CU_SOURCE = "src/repro_torch/kernels/range_scorer/csrc/range_scorer.cu"
TPU_SCORER = "src/repro/kernels/range_scorer/kernel.py"
BAG_SOURCE = "src/repro_torch/kernels/embedding_bag/csrc/embedding_bag.cu"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (data sheet)
FP32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores (data sheet)
# The bag reduce at the CPU tests' shapes (tests/test_kernels_embedding_bag.py).
BAG_TEST_SHAPES = [(4, 3, 8), (17, 20, 32), (128, 200, 64), (33, 7, 130)]
# The recsys configurations' published widths, copied because the smoke
# imports nothing of the JAX package: (label, n_items, B, L, D).
#   MIND      src/repro/configs/other_archs.py:25-30 (8,388,608 items, 64, history 50)
#   BERT4Rec  src/repro/configs/other_archs.py:55-60 (1,048,576 items, 64, history 200)
#   batches   src/repro/configs/base.py:486-491 (serve_p99 512, serve_bulk 262,144)
BAG_FULL_SHAPES = [
    ("mind serve_p99", 8_388_608, 512, 50, 64),
    ("mind serve_bulk", 8_388_608, 262_144, 50, 64),
    ("bert4rec serve_p99", 1_048_576, 512, 200, 64),
]
BAG_PAD_SHARE = 5  # the last L // 5 ids of every bag are padding (-1)
# Kernel vs plain version: the kernel sums L terms in ascending order, the
# plain version's einsum (a batched matmul, TF32 off) in another order;
# bfloat16 rounds once at the end on both sides (the JAX test's tolerance).
BAG_TOL = {"float32": (1e-5, 1e-4), "bfloat16": (2e-2, 2e-2)}  # (rtol, atol)
CONFIGS = [(dt, fmt) for dt in ("int32", "int8") for fmt in ("int32", "packed")]
STEP_KS = (1, 10, 1000, 1025, 2048)  # the range kernels' parity grid of k
WIDE_K = 2048  # the engine run at a k above the port's former limit of 1,024
# Dependent global rounds on a step's critical path: block ids, their
# directory rows, their postings.
DEP_ROUNDS = 3
N_QUERIES = 200
SCALE_ANYTIME_QUERIES = 48  # the anytime loop's parity at scale (all N_QUERIES at preset)
# At scale, the queries held against the plain path (all N_QUERIES against
# the oracle or Engine.traverse) and the sharded path's: cut from 200 and 64
# so that the control phase fits the smoke's earlier wall time.
SCALE_PLAIN_QUERIES = 96
SCALE_SHARDED_PLAIN_QUERIES = 32
QUERY_SEED = 42
BATCH = 16  # the batch and sharded windows' micro-batch, the in-flight window's slots
SHARDS = 4  # the sharded serving window's range shards (launch/serve.py --mode sharded)
MAX_BATCH = 32  # batch parity's largest bucket (BucketSpec's default)
PRESET = dict(n_docs=24_000, n_terms=12_000, n_topics=24, mean_doc_len=220,
              n_ranges=32, strategy="clustered_bp")
SCALE = dict(n_docs=250_000, n_terms=50_000, n_topics=32, mean_doc_len=220,
             n_ranges=32, strategy="clustered")


class SmokeError(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeError(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------- host build


def build_corpus_index(src: str, cfg: dict, n_queries: int,
                       cache_dir: str | None = None) -> dict:
    """Worker: corpus, index and query log, returned as numpy arrays.

    With ``cache_dir`` the index goes through ``build_index_cached`` (an
    artifact under ``cache_dir``): ``cache`` then says whether the entry was
    there (a hit, checked with ``validate_artifact``) or built and saved.
    """
    import os

    sys.path.insert(0, src)
    from repro_torch import index_io
    from repro_torch.core.clustered_index import (
        INDEX_ARRAYS, build_index, build_index_cached)
    from repro_torch.data.synth import make_corpus, make_query_log

    t0 = time.perf_counter()
    corpus = make_corpus(n_docs=cfg["n_docs"], n_terms=cfg["n_terms"],
                         n_topics=cfg["n_topics"], mean_doc_len=cfg["mean_doc_len"],
                         seed=0)
    t1 = time.perf_counter()
    build = dict(n_ranges=cfg["n_ranges"], strategy=cfg["strategy"], bits=8, seed=0)
    cache = None
    if cache_dir is None:
        index = build_index(corpus, **build)
    else:
        before = set(os.listdir(cache_dir)) if os.path.isdir(cache_dir) else set()
        index = build_index_cached(corpus, cache_dir=cache_dir, **build)
        entries = [e for e in os.listdir(cache_dir) if e.startswith("index_")]
        hit = bool(before & set(entries))
        t_hit = time.perf_counter()
        problems = [index_io.validate_artifact(os.path.join(cache_dir, e))
                    for e in sorted(before & set(entries))] if hit else []
        cache = dict(hit=hit, entries=sorted(entries), seconds=t_hit - t1,
                     validate_s=time.perf_counter() - t_hit, problems=problems)
    t2 = time.perf_counter()
    terms = make_query_log(corpus, n_queries=n_queries, seed=QUERY_SEED).terms
    arrays = {n: getattr(index, n) for n in INDEX_ARRAYS
              if n not in ("doc_order", "range_ends")}
    arrays["doc_order"] = index.arrangement.doc_order
    arrays["range_ends"] = index.arrangement.range_ends
    return dict(
        arrays=arrays,
        meta=dict(n_docs=index.n_docs, n_terms=index.n_terms,
                  strategy=index.arrangement.strategy,
                  quant_bits=index.quantizer.bits, quant_scale=index.quantizer.scale),
        terms=terms,
        fingerprint=index.fingerprint(),
        cache=cache,
        corpus_s=t1 - t0,
        index_s=t2 - t1,
        query_s=time.perf_counter() - t2,
    )


def receive_index(job, label: str):
    from repro_torch.core.clustered_index import index_from_arrays

    t0 = time.perf_counter()
    out = job.get()
    index = index_from_arrays(out["arrays"], **out["meta"])
    check(index.fingerprint() == out["fingerprint"], f"{label}: fingerprint changed in transfer")
    queries = [out["terms"][i] for i in range(out["terms"].shape[0])]
    cache = out["cache"]
    if cache is not None:
        # A hit must be a valid artifact: validate_artifact checked every
        # checksum and the fingerprint in the worker.
        check(all(p == [] for p in cache["problems"]),
              f"{label}: cached index artifact invalid: {cache['problems']}")
        log(f"{label}: build_index_cached {'HIT' if cache['hit'] else 'MISS'} in "
            f"{cache['seconds']:.1f} s under .cache/ ({cache['entries']})"
            + (f", validate_artifact ok in {cache['validate_s']:.1f} s" if cache["hit"]
               else ": no entry from an earlier run, built and saved"))
    log(f"{label}: host build corpus {out['corpus_s']:.1f} s, index "
        f"{out['index_s']:.1f} s (numpy, worker process); waited "
        f"{time.perf_counter() - t0:.1f} s; {index.n_docs} docs, {index.nnz} "
        f"postings, {index.n_blocks} blocks, {index.n_ranges} ranges, "
        f"max range {index.max_range_size} docs")
    return index, queries, {k: out[k] for k in ("corpus_s", "index_s", "query_s",
                                                 "cache")}


# -------------------------------------------------------------- kernel phase


class Parity:
    """Largest |kernel - plain| seen per kernel, over every comparison."""

    def __init__(self):
        self.max_err = {"scatter_accumulate": 0, "unpack_locals": 0, "range_step": 0,
                        "traverse": 0, "bag_reduce": 0.0}
        self.cases = {"scatter_accumulate": 0, "unpack_locals": 0, "range_step": 0,
                      "traverse": 0, "bag_reduce": 0}
        self.float_err = {}  # (name, dtype) -> largest |err|

    def record(self, name: str, got, want, ctx: str) -> None:
        import torch

        torch.cuda.synchronize()
        check(got.shape == want.shape and got.dtype == want.dtype,
              f"{name} {ctx}: {tuple(got.shape)}/{got.dtype} vs "
              f"{tuple(want.shape)}/{want.dtype}")
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max().item()) \
            if got.numel() else 0
        self.max_err[name] = max(self.max_err[name], err)
        self.cases[name] += 1
        check(err == 0, f"{name} {ctx}: kernel differs from plain version by {err}")

    def record_state(self, got, want, ctx: str) -> None:
        """A range step's new state, every field, bitwise."""
        import torch

        def flat(st):
            return torch.cat([st.vals, st.postings[None], st.blocks[None], st.ids])

        self.record("range_step", flat(got), flat(want), ctx)

    def record_carry(self, got, want, k: int, ctx: str) -> None:
        """A traversal's [N, 2k+5] carry, every field of every lane, bitwise."""
        fields = (("vals", slice(0, k)), ("postings", slice(k, k + 1)),
                  ("blocks", slice(k + 1, k + 2)), ("ids", slice(k + 2, 2 * k + 2)),
                  ("i", slice(2 * k + 2, 2 * k + 3)),
                  ("exit_safe", slice(2 * k + 3, 2 * k + 4)),
                  ("exit_budget", slice(2 * k + 4, 2 * k + 5)))
        check(got.shape == want.shape, f"traverse {ctx}: shape {tuple(got.shape)} vs "
              f"{tuple(want.shape)}")
        for name, col in fields:
            self.record("traverse", got[:, col], want[:, col], f"{ctx} {name}")

    def record_close(self, name: str, got, want, ctx: str) -> None:
        """Float outputs within ``BAG_TOL`` of the plain version's.

        ``name`` is a kernel, or a yardstick checked before it is timed.
        """
        import torch

        torch.cuda.synchronize()
        dtype = str(want.dtype).removeprefix("torch.")
        check(got.shape == want.shape and got.dtype == want.dtype,
              f"{name} {ctx}: {tuple(got.shape)}/{got.dtype} vs "
              f"{tuple(want.shape)}/{want.dtype}")
        rtol, atol = BAG_TOL[dtype]
        g, w = got.to(torch.float32), want.to(torch.float32)
        diff = (g - w).abs()
        err = float(diff.max().item()) if diff.numel() else 0.0
        over = int((diff > atol + rtol * w.abs()).sum().item()) if diff.numel() else 0
        check(bool(torch.isfinite(g).all().item()), f"{name} {ctx}: non-finite output")
        self.max_err[name] = max(self.max_err.get(name, 0.0), err)
        key = (name, dtype)
        self.float_err[key] = max(self.float_err.get(key, 0.0), err)
        self.cases[name] = self.cases.get(name, 0) + 1
        check(over == 0, f"{name} {ctx} {dtype}: {over} outputs beyond rtol {rtol}, "
              f"atol {atol} of the plain version (max |err| {err})")


def _packed_pool(rng, n_pool, max_deltas=(0, 1, 200, 255, 300, 70_000)):
    import numpy as np
    from repro_torch.core.clustered_index import BLOCK, pack_docs

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
    return docs, blk_start, blk_len, pack_docs(docs, blk_start, blk_len)


def step_case(rng, dev, s_pad, impact_dtype, docs_format, k, theta, n_blocks=256):
    """A range-step input on ``dev``: a pool of blocks with sorted docids in
    one range of ``s_pad`` docs, ``n_blocks`` of them listed (the last few
    -1), and a state that is empty (``theta`` 0) or full with θ > 0."""
    import numpy as np
    import torch
    from repro_torch.core.clustered_index import BLOCK, pack_dir_entries, pack_docs
    from repro_torch.core.range_daat import DeviceIndex
    from repro_torch.kernels.range_scorer import ref

    def t(a, dtype=np.int32):
        a = np.ascontiguousarray(a if dtype is None else np.asarray(a).astype(dtype))
        return torch.from_numpy(a).to(dev)

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
    cols = dict(docs=docs, blk_start=starts, blk_len=lens, blk_maximp=maximp,
                bounds_dense=np.zeros((1, 1)), range_starts=np.array([rs]),
                range_sizes=np.array([s_pad]))
    if docs_format == "packed":
        packed = pack_docs(docs, starts, lens)
        cols.update(docs=np.zeros(1), pack_words=np.asarray(packed.words,
                                                            np.uint32).view(np.int32),
                    pack_dir=pack_dir_entries(packed), pack_first=packed.blk_first)
    dix = DeviceIndex(impacts=t(stored, None), **{n: t(a) for n, a in cols.items()})
    blk = rng.choice(n_pool, size=n_blocks, replace=False).astype(np.int32)
    blk[-3:] = -1
    rest = rng.integers(0, 400, size=n_blocks)
    buf = np.zeros(2 * k + 2, np.int32)
    buf[k + 2:] = -1
    if theta:
        buf[:k] = np.sort(rng.integers(theta, theta + 200, size=k))[::-1]
        buf[k + 2:] = rng.choice(np.arange(rs + s_pad, rs + s_pad + 4 * k), size=k,
                                 replace=False)
        buf[k:k + 2] = (12_345, 67)
    return (dix, ref.state_views(t(buf), k), t(blk), t(rest),
            torch.tensor(rs, dtype=torch.int32, device=dev))


def traverse_case(rng, dev, s_pad, impact_dtype, docs_format, k, n_lanes, ties=False,
                  n_ranges=5, n_blocks=48):
    """``traverse`` inputs on ``dev``: R ranges of ``s_pad`` docs, each with a
    pool of blocks of sorted docids; per lane a random block table (-1
    padded), order and descending bounds; budgets and caps mixing
    unbounded, small and 0 (the last lane a dummy: budget 0, cap 0); and a
    carry that is fresh, or mid-flight with a full tie-heavy state (θ > 0),
    or parked. ``ties`` draws every impact from {3, 5}."""
    import numpy as np
    import torch
    from repro_torch.core.clustered_index import BLOCK, pack_dir_entries, pack_docs
    from repro_torch.core.range_daat import DeviceIndex
    from repro_torch.kernels.range_scorer import ref

    def t(a, dtype=np.int32):
        a = np.ascontiguousarray(a if dtype is None else np.asarray(a).astype(dtype))
        return torch.from_numpy(a).to(dev)

    R, pool = n_ranges, 64
    docs, starts, lens, pools = [], [], [], []
    off = 0
    for r in range(R):
        ln = rng.integers(1, BLOCK + 1, size=pool)
        ln[::5] = BLOCK
        ids = []
        for n in ln:
            docs.append(np.sort(rng.choice(s_pad, size=int(n), replace=False))
                        + 1_000 + r * s_pad)
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
    cols = dict(docs=docs, blk_start=starts, blk_len=lens, blk_maximp=maximp,
                bounds_dense=np.zeros((1, 1)), range_starts=1_000 + np.arange(R) * s_pad,
                range_sizes=np.full(R, s_pad))
    if docs_format == "packed":
        packed = pack_docs(docs, starts, lens)
        cols.update(docs=np.zeros(1), pack_words=np.asarray(packed.words,
                                                            np.uint32).view(np.int32),
                    pack_dir=pack_dir_entries(packed), pack_first=packed.blk_first)
    dix = DeviceIndex(impacts=t(stored, None), **{n: t(a) for n, a in cols.items()})
    N = n_lanes
    blk = np.full((N, R, n_blocks), -1, np.int32)
    for n in range(N):
        for r in range(R):
            m = int(rng.integers(0, n_blocks + 1))
            blk[n, r, :m] = rng.choice(pools[r], size=m, replace=False)
    rest = rng.integers(0, 400, size=(N, R, n_blocks))
    order = np.stack([rng.permutation(R) for _ in range(N)])
    bounds = -np.sort(-rng.integers(0, 2_500, size=(N, R)), axis=1)
    budget = rng.choice([0, 60, 700, 4_000, 2**31 - 1], size=N)
    maxr = rng.choice([0, 1, 3, R, 2**31 - 1], size=N)
    budget[:N // 2 + 1] = 2**31 - 1  # at least half the lanes run freely
    maxr[:N // 2 + 1] = 2**31 - 1
    if N > 1:
        budget[-1] = maxr[-1] = 0  # a dummy lane
    width = ref.carry_width(k)
    carry = np.zeros((N, width), np.int32)
    carry[:, k + 2:2 * k + 2] = -1
    for n in range(N):
        if n % 4 == 2:  # mid-flight, a full state tied at θ
            theta = int(rng.integers(20, 400))
            carry[n, :k] = np.sort(rng.choice([theta, theta, theta + 7, theta + 40],
                                              size=k))[::-1]
            carry[n, k + 2:2 * k + 2] = rng.choice(
                np.arange(1_000 + R * s_pad, 1_000 + R * s_pad + 4 * k), size=k,
                replace=False)
            carry[n, k:k + 2] = rng.integers(0, 3_000, size=2)
            carry[n, 2 * k + 2] = rng.integers(0, R)
        elif n % 4 == 3 and n != N - 1:  # parked
            carry[n, 2 * k + 4] = 1
    return dix, [t(a) for a in (blk, rest, order, bounds, budget, maxr, carry)]


def traverse_phase(dev, parity: Parity) -> None:
    """``traverse`` against ``traverse_ref``, bitwise, on every carry field:
    both accumulator placements, k 1/10/1000/1025/2048 and k = s_pad at
    s_pad 256, N 1/5/32 with dummy and
    parked lanes, four configurations, plain and tie-heavy impacts,
    quantum None/1/2/3 with each chained run equal to the uninterrupted one."""
    import numpy as np
    from repro_torch.kernels.range_scorer import kernel, ref

    for s_pad, ks in ((9_984, STEP_KS), (65_536, STEP_KS), (256, (256,))):
        for ki, k in enumerate(ks):
            rng = np.random.default_rng(s_pad + 7 * k)
            for ci, (dt, fmt) in enumerate(CONFIGS):
                n_lanes = (1, 5, 32)[(ci + ki) % 3]
                ties = (ci + ki) % 2 == 1
                dix, lanes = traverse_case(rng, dev, s_pad, dt, fmt, k, n_lanes, ties)
                kw = dict(s_pad=s_pad, k=k, docs_format=fmt)
                ctx = (f"s_pad={s_pad} ({kernel.acc_placement(s_pad, 'traverse', k)} acc, "
                       f"{kernel.top_placement(k, 'traverse')} top-k) k={k} {dt}/{fmt} "
                       f"N={n_lanes} ties={ties}")
                whole = kernel.traverse(dix, *lanes, **kw)
                parity.record_carry(whole, ref.traverse_ref(dix, *lanes, **kw), k, ctx)
                for quantum in (1, 2, 3):
                    carry = kernel.traverse(dix, *lanes, quantum=quantum, **kw)
                    parity.record_carry(carry, ref.traverse_ref(dix, *lanes,
                                                                quantum=quantum, **kw),
                                        k, f"{ctx} quantum={quantum}")
                    for _ in range(6):
                        carry = kernel.traverse(dix, *lanes[:-1], carry, quantum=quantum,
                                                **kw)
                    parity.record_carry(carry, whole, k,
                                        f"{ctx} chained quantum={quantum}")


def stacked_traverse_case(rng, dev, s_pad, impact_dtype, docs_format, k, n_queries,
                          n_shards, clamp=True):
    """``traverse`` inputs over S stacked range shards of unequal size on
    ``dev``: shard s is a ``traverse_case`` of R_max - s ranges (its padded
    order slots point at an all -1 row with zero bounds), every column
    padded to the widest row, and lane q * S + s reads shard s. With
    ``clamp`` the widest shard's last block is stretched to 128 postings,
    past its row's end, and listed first in its range for every lane of
    that shard, so its gathers reach the clamp at the row's end."""
    import numpy as np
    import torch
    from repro_torch.core.clustered_index import BLOCK
    from repro_torch.core.range_daat import DeviceIndex
    from repro_torch.kernels.range_scorer import ref

    R, cpu = n_shards + 2, torch.device("cpu")
    shards = [traverse_case(rng, cpu, s_pad, impact_dtype, docs_format, k, n_queries,
                            n_ranges=R - s) for s in range(n_shards)]
    names = [n for n in shards[0][0]._fields if getattr(shards[0][0], n) is not None]
    cols = {n: [getattr(d, n).numpy() for d, _ in shards] for n in names}
    last = len(cols["blk_len"][0]) - 1
    if clamp:
        cols["blk_len"][0] = cols["blk_len"][0].copy()
        cols["blk_len"][0][last] = BLOCK

    def stack(rows):
        out = np.zeros((len(rows), max(max(len(r) for r in rows), 1)), rows[0].dtype)
        for i, r in enumerate(rows):
            out[i, :len(r)] = r
        return out

    cols = {n: stack(c) for n, c in cols.items()}
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
    return dix, [torch.from_numpy(a).to(dev) for a in (blk, rest, order, bounds, caps[0],
                                                       caps[1], carry)]


def stacked_traverse_phase(dev, parity: Parity) -> None:
    """``traverse`` over stacked shards against ``traverse_ref``, bitwise, on
    every carry field: both accumulator placements, k 1/10/1024, S 2/3/4,
    four configurations, chained quanta equal to one run; and one stacked
    shard equal to the unstacked index."""
    import numpy as np
    from repro_torch.core.range_daat import DeviceIndex
    from repro_torch.kernels.range_scorer import kernel, ref

    for s_pad, k in ((9_984, 10), (65_536, 1), (9_984, 1024)):
        rng = np.random.default_rng(s_pad + k + 1)
        for ci, (dt, fmt) in enumerate(CONFIGS):
            n_shards = (2, 3, 4, 2)[ci]
            dix, lanes = stacked_traverse_case(rng, dev, s_pad, dt, fmt, k, 3, n_shards)
            kw = dict(s_pad=s_pad, k=k, docs_format=fmt)
            ctx = f"stacked s_pad={s_pad} k={k} {dt}/{fmt} S={n_shards}"
            whole = kernel.traverse(dix, *lanes, **kw)
            parity.record_carry(whole, ref.traverse_ref(dix, *lanes, **kw), k, ctx)
            for quantum in (1, 3):
                carry = kernel.traverse(dix, *lanes, quantum=quantum, **kw)
                parity.record_carry(carry, ref.traverse_ref(dix, *lanes, quantum=quantum,
                                                            **kw), k, f"{ctx} q={quantum}")
                for _ in range(8):
                    carry = kernel.traverse(dix, *lanes[:-1], carry, quantum=quantum, **kw)
                parity.record_carry(carry, whole, k, f"{ctx} chained quantum={quantum}")
    for dt, fmt in CONFIGS:
        dix, lanes = stacked_traverse_case(np.random.default_rng(3), dev, 9_984, dt, fmt,
                                           10, 5, 1, clamp=False)
        flat = DeviceIndex(*(None if t is None else t[0].contiguous() for t in dix))
        kw = dict(s_pad=9_984, k=10, docs_format=fmt)
        parity.record_carry(kernel.traverse(dix, *lanes, **kw),
                            kernel.traverse(flat, *lanes, **kw), 10,
                            f"one stacked shard == unstacked {dt}/{fmt}")


def kernel_phase(dev, parity: Parity) -> None:
    import numpy as np
    import torch
    from repro_torch.core.clustered_index import BLOCK, pack_dir_entries
    from repro_torch.kernels.range_scorer import kernel, ref

    def t(a, dtype=None):
        a = np.ascontiguousarray(a if dtype is None else np.asarray(a).astype(dtype))
        return torch.from_numpy(a).to(dev)

    # Scatter: the CPU tests' shapes plus main-path widths B and s_pad.
    shapes = [(128, 1), (384, 7), (1024, 32)] + [
        (s, b) for b in (32, 64, 128) for s in (128, 2_048, 16_384, 32_768)]
    for s_pad, n_blocks in shapes:
        rng = np.random.default_rng(s_pad * 1000 + n_blocks)
        nnz = 200_000
        docs = np.sort(rng.integers(0, s_pad, size=nnz)).astype(np.int32)
        imps = rng.integers(1, 256, size=nnz).astype(np.int32)
        starts = rng.integers(0, nnz - BLOCK, size=n_blocks).astype(np.int32)
        lens = rng.integers(1, BLOCK + 1, size=n_blocks).astype(np.int32)
        keep = rng.random(n_blocks) < 0.8
        for stored in (imps, (imps.astype(np.int64) - 128).astype(np.int8)):
            local, vals = ref.gather_block_postings(
                t(docs), t(stored), t(starts), t(lens), t(keep), 5)
            got = kernel.scatter_accumulate(local, vals, s_pad)
            parity.record("scatter_accumulate", got,
                          ref.scatter_accumulate_ref(local, vals, s_pad),
                          f"s_pad={s_pad} B={n_blocks}")
    rng = np.random.default_rng(1)
    ids = rng.integers(-1, 1100, size=3000).astype(np.int32)
    vals = rng.integers(0, 256, size=3000).astype(np.int32)
    parity.record("scatter_accumulate", kernel.scatter_accumulate(t(ids), t(vals), 900),
                  ref.scatter_accumulate_ref(t(ids), t(vals), 900), "out-of-range ids")

    # Decode: every width, pruned and padding rows, main-path widths.
    for seed, n_pool, n_sel in ((0, 24, 17), (3, 24, 17), (9, 24, 17),
                                (5, 256, 32), (6, 256, 64), (7, 256, 128)):
        rng = np.random.default_rng(seed)
        _, blk_start, blk_len, packed = _packed_pool(rng, n_pool)
        words = t(np.asarray(packed.words, np.uint32).view(np.int32))
        sel = rng.integers(0, n_pool, size=n_sel)
        starts = blk_start[sel].astype(np.int32)
        starts[-2:] = -1  # engine padding rows
        cols = [t(starts), t(blk_len[sel], np.int32),
                t(pack_dir_entries(packed)[sel], np.int32),
                t(packed.blk_first[sel], np.int32)]
        for keep in (rng.random(n_sel) < 0.8, np.zeros(n_sel, bool)):
            for r0 in (0, 37):
                args = (words, *cols, t(keep),
                        torch.tensor(r0, dtype=torch.int32, device=dev))
                parity.record("unpack_locals", kernel.unpack_locals(*args),
                              ref.unpack_locals_ref(*args),
                              f"seed={seed} B={n_sel} r0={r0}")

    # The fused range step: both accumulator placements, any k up to s_pad
    # (the top-k scratch in shared memory up to 2,048 and, at k = s_pad, in
    # global memory), ties at the k-th score (a third of the impacts are
    # 9), an empty state (θ = 0) and a full one.
    for s_pad, ks in ((9_984, STEP_KS), (65_536, STEP_KS), (256, (256,))):
        for k in ks:
            rng = np.random.default_rng(s_pad + k)
            for dt, fmt in CONFIGS:
                for theta in (0, 300):
                    dix, state, blk, rest, rs = step_case(
                        rng, dev, s_pad, dt, fmt, k, theta,
                        n_blocks=8 if s_pad == 256 else 256)
                    for prune in (True, False):
                        kw = dict(s_pad=s_pad, k=k, prune_blocks=prune, docs_format=fmt)
                        parity.record_state(
                            kernel.range_step(dix, state, blk, rest, rs, **kw),
                            ref.range_step_ref(dix, state, blk, rest, rs, **kw),
                            f"s_pad={s_pad} ({kernel.acc_placement(s_pad, k=k)} acc, "
                            f"{kernel.top_placement(k)} top-k) k={k} {dt}/{fmt} "
                            f"theta={theta} prune={prune}")
    for k in (0, 65_537):
        try:
            kernel.range_step(dix, ref.init_state(max(k, 1), dev), blk, rest, rs,
                              s_pad=65_536, k=k)
        except ValueError:
            continue
        raise SmokeError(f"range_step took k = {k} at s_pad 65,536")


# ----------------------------------------------------------------- bag phase


def bag_bound(B: int, L: int, D: int, itemsize: int = 4) -> dict:
    """Least time for the bag reduce: rows, weights and outputs moved once."""
    nbytes = (B * L * D + B * L + B * D) * itemsize
    ops = 2 * B * L * D
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    return dict(bytes=nbytes, ops=ops, bound_ms=max(by_bytes, by_ops),
                bound_by="bytes" if by_bytes >= by_ops else "operations")


def bag_full_inputs(V: int, B: int, L: int, D: int, dev, seed: int):
    """Table [V, D], ids [B, L] (trailing fifth -1) and weights, made on the card."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    table = torch.randn((V, D), generator=g, device=dev)
    ids = torch.randint(0, V, (B, L), generator=g, device=dev, dtype=torch.int32)
    ids[:, L - L // BAG_PAD_SHARE:] = -1
    weights = torch.randn((B, L), generator=g, device=dev)
    return table, ids, weights


def bag_phase(dev, parity: Parity, full_shapes=BAG_FULL_SHAPES) -> dict:
    """Kernel parity at the tests' shapes, then the lookup at full width."""
    import numpy as np
    import torch
    from repro_torch.kernels.embedding_bag import kernel
    from repro_torch.kernels.embedding_bag.ref import bag_reduce_plain
    from repro_torch.models.embedding import bag_inputs, combine_bags, embedding_bag

    check(not torch.backends.cuda.matmul.allow_tf32
          and torch.get_float32_matmul_precision() == "highest",
          "float32 matmul must run without TF32 for the plain version")
    t0 = time.perf_counter()
    dtypes = (torch.float32, torch.bfloat16)
    combos = [(wt, c) for wt in (False, True) for c in ("sum", "mean")]

    def lookup_case(table, ids, weights, ctx):
        for wt, combine in combos:
            wts = weights if wt else None
            got = embedding_bag(table, ids, wts, combine)
            rows, w = bag_inputs(table, ids, wts)
            want = combine_bags(bag_reduce_plain(rows, w), w, combine)
            del rows, w
            parity.record_close("bag_reduce", got, want,
                                f"{ctx} weighted={wt} {combine}")

    # The CPU tests' shapes: the reduce alone, then the lookup around it,
    # with padding and ids past the table's end (clamped to its last row).
    for B, L, D in BAG_TEST_SHAPES:
        rng = np.random.default_rng(B * 1000 + L)
        rows = torch.from_numpy(rng.normal(0, 1, size=(B, L, D)).astype(np.float32)).to(dev)
        w = torch.from_numpy(rng.normal(0, 1, size=(B, L)).astype(np.float32)).to(dev)
        ids = rng.integers(0, 1010, size=(B, L)).astype(np.int32)
        ids[:, L - L // BAG_PAD_SHARE:] = -1
        ids = torch.from_numpy(ids).to(dev)
        table = torch.from_numpy(rng.normal(0, 1, size=(1000, D)).astype(np.float32)).to(dev)
        for dt in dtypes:
            r, ww = rows.to(dt), w.to(dt)
            parity.record_close("bag_reduce", kernel.bag_reduce(r, ww),
                                bag_reduce_plain(r, ww), f"B={B} L={L} D={D}")
            lookup_case(table.to(dt), ids, w.to(dt), f"lookup B={B} L={L} D={D}")

    # The main path: the lookup at published widths, counters reset just
    # before and read just after. Plain versions launch no kernel.
    kernel.bag_reduce.launches = 0
    for i, (label, V, B, L, D) in enumerate(full_shapes):
        table, ids, weights = bag_full_inputs(V, B, L, D, dev, seed=i)
        for dt in dtypes:
            lookup_case(table.to(dt), ids, weights.to(dt), label)
        del table, ids, weights
    launches = kernel.bag_reduce.launches
    check(launches > 0, "bag_reduce was never launched on the main path")
    torch.cuda.synchronize()
    max_err = {dt: parity.float_err[("bag_reduce", dt)] for dt in BAG_TOL}
    log(f"bag: bag_reduce ({parity.cases['bag_reduce']} cases): max |err| "
        f"float32 {max_err['float32']:.3e} (rtol/atol {BAG_TOL['float32']}), "
        f"bfloat16 {max_err['bfloat16']:.3e} (rtol/atol {BAG_TOL['bfloat16']}); "
        f"main path {launches} launches over {len(full_shapes)} full-width shapes; "
        f"{time.perf_counter() - t0:.1f} s")
    return {"launches": launches, "max_err": max_err}


def bag_timings(dev, parity: Parity, full_shapes=BAG_FULL_SHAPES) -> dict:
    """The bag reduce at each full-width shape (float32, weighted sum)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.embedding_bag import kernel
    from repro_torch.kernels.embedding_bag.ref import bag_reduce_plain
    from repro_torch.models.embedding import bag_inputs, embedding_bag

    out = {}
    for i, (label, V, B, L, D) in enumerate(full_shapes):
        table, ids, weights = bag_full_inputs(V, B, L, D, dev, seed=i)
        rows, w = bag_inputs(table, ids, weights)
        want = bag_reduce_plain(rows, w)
        w3 = w[:, None]
        bmm = functools.partial(torch.bmm, w3, rows)
        parity.record_close("torch.bmm", bmm()[:, 0], want, label)

        def lookup_lib():
            return F.embedding_bag(ids.clamp(min=0), table, per_sample_weights=w,
                                   mode="sum")

        parity.record_close("F.embedding_bag", lookup_lib(), want, label)
        wrapper = functools.partial(kernel.bag_reduce, rows, w)
        plain = functools.partial(bag_reduce_plain, rows, w)
        lookup = functools.partial(embedding_bag, table, ids, weights)
        iters = 50 if B * L * D > 1e8 else 200
        tm = dict(
            shape=f"B={B} L={L} D={D} V={V}",
            ms=time_ms(wrapper, iters), plain_ms=time_ms(plain, iters),
            library_ms=time_ms(bmm, iters),
            lookup_ms=time_ms(lookup, iters), library_lookup_ms=time_ms(lookup_lib, iters),
            kernel_device_us=device_us(wrapper, "bag_reduce_kernel", iters // 2),
            plain_device_us=device_us(plain, None, iters // 2),
            library_device_us=device_us(bmm, None, iters // 2),
            lookup_device_us=device_us(lookup, None, iters // 2),
            library_lookup_device_us=device_us(lookup_lib, None, iters // 2),
            **bag_bound(B, L, D),
        )
        # Where the port's whole lookup spends its device time, per call.
        tm["lookup_ops"] = [
            dict(name=e.key[:80], us=_self_device_us(e) / (iters // 2),
                 count=e.count / (iters // 2))
            for e in sorted(_profile_rows(lookup, iters // 2), key=_self_device_us,
                            reverse=True)]
        out[label] = tm
        log(f"bag_reduce {label} [{tm['shape']}] float32: {tm['ms'] * 1e3:.2f} us/call "
            f"(device-only {tm['kernel_device_us']:.2f} us), bound "
            f"{tm['bound_ms'] * 1e3:.3f} us ({tm['bytes']} B, {tm['bound_by']}); plain "
            f"{tm['plain_ms'] * 1e3:.2f} us (device {tm['plain_device_us']:.2f}), "
            f"torch.bmm {tm['library_ms'] * 1e3:.2f} us (device "
            f"{tm['library_device_us']:.2f}); whole lookup: port "
            f"{tm['lookup_ms'] * 1e3:.2f} us (device {tm['lookup_device_us']:.2f}), "
            f"F.embedding_bag {tm['library_lookup_ms'] * 1e3:.2f} us (device "
            f"{tm['library_lookup_device_us']:.2f})")
        for row in tm["lookup_ops"]:
            log(f"  lookup {row['us']:10.2f} us  x{row['count']:<4g} {row['name']}")
        del table, ids, weights, rows, w, w3, want
        torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------- engine phases


def observe(engine, plan, budget=None, max_ranges=None) -> tuple:
    """The seven ``observe_query`` fields of one ``Engine.traverse``."""
    kw = {} if budget is None else {"budget_postings": int(budget)}
    if max_ranges is not None:
        kw["max_ranges"] = int(max_ranges)
    res = engine.traverse(plan, **kw)
    ids, vals = engine.topk_docs(res.state)
    return (ids.tolist(), vals.tolist(), int(res.state.postings),
            int(res.state.blocks), int(res.ranges_processed),
            bool(res.exit_safe), bool(res.exit_budget))


def rank_safe(ids, vals, oracle_topk, scores) -> bool:
    """A safe exit's top-k against the oracle's, up to ties at the k-th score.

    Safe termination and block pruning stop at bounds <= θ, so a document
    tying the k-th score may lose its place to one with a larger docid
    (the reference's own tests compare score multisets for this reason).
    Scores must match exactly, the documents above the k-th score must
    match in order, and every document at the k-th score must truly have it.
    """
    oids, ovals = (x.tolist() for x in oracle_topk)
    if vals != ovals:
        return False
    kth = vals[-1] if vals else 0
    above = [d for d, v in zip(ids, vals) if v > kth]
    return above == [d for d, v in zip(oids, ovals) if v > kth] and all(
        int(scores[d]) == kth for d, v in zip(ids, vals) if v == kth)


SCORER_KERNELS = ("range_step", "traverse", "scatter_accumulate", "unpack_locals")


def reset_launches() -> None:
    from repro_torch.kernels.range_scorer import kernel

    for name in SCORER_KERNELS:
        getattr(kernel, name).launches = 0


def read_launches() -> dict:
    from repro_torch.kernels.range_scorer import kernel

    return {name: getattr(kernel, name).launches for name in SCORER_KERNELS}


def check_launches(launches: dict, want: dict, ctx: str) -> None:
    """Exactly ``want`` launches of each named scorer kernel, none of the others."""
    full = {name: want.get(name, 0) for name in SCORER_KERNELS}
    check(any(full.values()), f"{ctx}: the path launched nothing to count")
    check(launches == full, f"{ctx}: launches {launches}, expected {full}")


def anytime_fields(res) -> tuple:
    """An ``AnytimeResult`` as ``observe``'s seven fields, the budget flag
    standing for a policy exit."""
    return (res.doc_ids.tolist(), res.scores.tolist(), res.postings, res.blocks,
            res.ranges_processed, res.exit_reason == "safe", res.exit_reason == "policy")


def anytime_parity(kern, plain, plans, whole, caps, name: str) -> dict:
    """The anytime loop (``Engine.step``, one ``range_step`` per range) on
    the kernel engine against the plain engine, every query run to its end
    and again under a ``Fixed`` cap of ``caps[i]`` ranges; both against the
    whole-query traversal (``whole``, and ``Engine.traverse`` under
    ``max_ranges``) on the top-k, counters, ranges and safe flag. A capped
    run and a traversal may both see the cap and a safe stop at one
    iteration; the anytime loop then reports the safe stop alone."""
    from repro_torch.core.anytime import Fixed, run_query_anytime

    out = {"launches": 0, "ranges": 0, "kernels_s": 0.0, "plain_s": 0.0}
    for capped in (False, True):
        policies = [Fixed(c) if capped else None for c in caps]
        reset_launches()
        t0 = time.perf_counter()
        got = [anytime_fields(run_query_anytime(kern, p, pol))
               for p, pol in zip(plans, policies)]
        out["kernels_s"] += time.perf_counter() - t0
        launches = read_launches()
        ranges = sum(g[4] for g in got)
        ctx = f"{name} anytime{' capped' if capped else ''}"
        check_launches(launches, {"range_step": ranges}, ctx)
        t0 = time.perf_counter()
        want = [anytime_fields(run_query_anytime(plain, p, pol))
                for p, pol in zip(plans, policies)]
        out["plain_s"] += time.perf_counter() - t0
        for i, (g, w) in enumerate(zip(got, want)):
            check(g == w, f"{ctx} query {i}: kernels {g} != plain {w}")
            trav = observe(kern, plans[i], max_ranges=caps[i]) if capped else whole[i]
            check(g[:6] == trav[:6], f"{ctx} query {i}: anytime {g} != traverse {trav}")
        out["launches"] += launches["range_step"]
        out["ranges"] += ranges
    return out


def four_way_parity(index, queries, label: str, dev, n_anytime: int | None = None,
                    n_plain: int | None = None) -> dict:
    """Kernel engines == plain engines on the card on the first ``n_plain``
    queries (None: all), unbudgeted and budgeted; == oracle on every safe
    exit; the anytime loop's kernel engine == its plain engine
    (``anytime_parity``) on the first ``n_anytime`` queries (None: all)."""
    import numpy as np
    from repro_torch.core.oracle import exhaustive_scores, exhaustive_topk
    from repro_torch.core.range_daat import Engine

    t0 = time.perf_counter()
    oracle = [(exhaustive_topk(index, q, 10), exhaustive_scores(index, q))
              for q in queries]
    oracle_s = time.perf_counter() - t0
    rng = np.random.default_rng(7)
    out = {"oracle_s": oracle_s, "engines": {}}
    for dt, fmt in CONFIGS:
        kern = Engine(index, k=10, device=dev, impact_dtype=dt, docs_format=fmt)
        plain = Engine(index, k=10, device=dev, impl="torch", impact_dtype=dt,
                       docs_format=fmt)
        check(kern.impl == "cuda", f"{label}: default impl on cuda is {kern.impl}")
        plans = [kern.plan(q) for q in queries]
        reset_launches()
        t0 = time.perf_counter()
        got = [observe(kern, p) for p in plans]
        kern.synchronize()
        kern_s = time.perf_counter() - t0
        launches = read_launches()
        t0 = time.perf_counter()
        want = [observe(plain, p) for p in plans[:n_plain]]
        plain.synchronize()
        plain_s = time.perf_counter() - t0
        name = f"{label} {dt}/{fmt}"
        for i, (g, w) in enumerate(zip(got, want)):
            check(g == w, f"{name} query {i}: kernels {g} != plain {w}")
        safe = 0
        for i, g in enumerate(got):
            if not g[6]:  # safe or exhausted: rank-safe, must match the oracle
                safe += 1
                check(rank_safe(g[0], g[1], *oracle[i]),
                      f"{name} query {i}: differs from the exhaustive oracle")
        ranges = sum(g[4] for g in got)
        # A whole-query traversal is one traverse launch, and nothing else.
        check_launches(launches, {"traverse": len(plans)}, name)
        budgets = [int(rng.integers(1, max(g[2], 1) + 1)) for g in got]
        reset_launches()
        budgeted = [observe(kern, p, b) for p, b in zip(plans, budgets)]
        budget_launches = read_launches()
        budget_ranges = sum(g[4] for g in budgeted)
        check_launches(budget_launches, {"traverse": len(plans)}, f"{name} budgeted")
        n_budget_exits = 0
        for i, (p, b, g) in enumerate(zip(plans, budgets, budgeted)):
            if n_plain is None or i < n_plain:
                w = observe(plain, p, b)
                check(g == w, f"{name} query {i} budget {b}: kernels {g} != plain {w}")
            n_budget_exits += g[6]
        caps = [int(rng.integers(0, g[4] + 1)) for g in got][:n_anytime]
        anytime = anytime_parity(kern, plain, plans[:len(caps)], got, caps, name)
        out["engines"][f"{dt}/{fmt}"] = dict(
            kernels_s=kern_s, plain_s=plain_s, plain_queries=len(want), ranges=ranges,
            launches=launches,
            budget_ranges=budget_ranges, budget_launches=budget_launches,
            safe_exits=safe, budget_exits=n_budget_exits, anytime=anytime)
        log(f"{name}: {len(queries)} queries, equal to plain for {len(want)} (unbudgeted "
            f"and budgeted) and to the oracle on {safe} safe/exhausted exits, "
            f"{n_budget_exits} budget exits; kernels {kern_s:.2f} s, plain "
            f"{plain_s:.2f} s; traverse launches {launches['traverse']} = queries "
            f"({ranges} ranges scored), budgeted {budget_launches['traverse']} "
            f"({budget_ranges} ranges); range_step and standalone scatter/decode "
            "launches 0")
        log(f"{name} anytime loop: {len(caps)} queries run to their end and "
            f"{len(caps)} under Fixed-n caps, kernels == plain == Engine.traverse; "
            f"range_step launches {anytime['launches']} = ranges scored "
            f"{anytime['ranges']}, nothing else; kernels {anytime['kernels_s']:.2f} s, "
            f"plain {anytime['plain_s']:.2f} s")
        del kern, plain
    return out


def wide_k_parity(index, queries, dev, n: int = 16) -> dict:
    """``Engine(impl="cuda", k=WIDE_K)`` == ``impl="torch"`` on every
    ``observe_query`` field for ``n`` queries, unbudgeted and budgeted, one
    ``traverse`` launch per query."""
    import numpy as np
    from repro_torch.core.range_daat import Engine
    from repro_torch.kernels.range_scorer import kernel

    kern = Engine(index, k=WIDE_K, device=dev, impact_dtype="int8", docs_format="packed")
    plain = Engine(index, k=WIDE_K, device=dev, impl="torch", impact_dtype="int8",
                   docs_format="packed")
    plans = [kern.plan(q) for q in queries[:n]]
    rng = np.random.default_rng(11)
    t0 = time.perf_counter()
    reset_launches()
    got = [observe(kern, p) for p in plans]
    launches = read_launches()
    check_launches(launches, {"traverse": len(plans)}, f"k={WIDE_K} engine")
    for i, (p, g) in enumerate(zip(plans, got)):
        w = observe(plain, p)
        check(g == w, f"k={WIDE_K} query {i}: kernels {g[2:]} != plain {w[2:]}")
        b = int(rng.integers(1, max(w[2], 1) + 1))
        gb, wb = observe(kern, p, b), observe(plain, p, b)
        check(gb == wb, f"k={WIDE_K} query {i} budget {b}: kernels {gb[2:]} != "
              f"plain {wb[2:]}")
    placements = (f"traverse: {kernel.acc_placement(kern.s_pad, 'traverse', WIDE_K)} "
                  f"accumulator, {kernel.top_placement(WIDE_K, 'traverse')} top-k scratch")
    out = dict(queries=len(plans), ranges=sum(g[4] for g in got), launches=launches,
               s_pad=kern.s_pad, acc=placements, seconds=time.perf_counter() - t0)
    log(f"k={WIDE_K} engine (int8/packed, {out['acc']}): {len(plans)} queries equal to "
        f"impl='torch' on every observe_query field, unbudgeted and budgeted; "
        f"{out['ranges']} ranges, traverse launches {launches['traverse']}; "
        f"{out['seconds']:.1f} s")
    return out


def time_ms(fn, iters: int = 200, warmup: int = 20) -> float:
    """Mean device time of one call: CUDA events around ``iters`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _device_events(prof) -> list:
    """The profiler's device-side rows (kernels, memsets, copies)."""
    return [e for e in prof.key_averages()
            if str(getattr(e, "device_type", "")).endswith("CUDA")]


def _self_device_us(e) -> float:
    t = getattr(e, "self_device_time_total", None)
    return float(e.self_cuda_time_total if t is None else t)


def _profile_rows(fn, iters: int, match: str | None = None) -> list:
    """The profiler's device rows over ``iters`` calls of ``fn``.

    With ``match``, only rows whose name contains it. A session that
    recorded no such row runs again, up to three sessions in all: late in
    a long run the profiler has lost a whole session's records (PERF.md).
    """
    import torch
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(3):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        rows = [e for e in _device_events(prof) if match is None or match in e.key]
        if rows:
            if attempt:
                log(f"  profiler: {attempt} session(s) recorded no device rows; "
                    "this one did")
            return rows
    return []


def device_us(fn, match: str | None = None, iters: int = 100) -> float:
    """Device time of one call, from the profiler: no launch gaps.

    With ``match``, only the kernel whose name contains it (launched once
    per call), per launch kept; else every device operation the call
    issues (fills, kernels, copies), per call.
    """
    rows = _profile_rows(fn, iters, match)
    check(bool(rows), f"profiler recorded no device time for {match or 'the call'}")
    total = sum(_self_device_us(e) for e in rows)
    if match is None:
        return total / iters
    # Each call launches the matched kernel once: divide by the launches
    # the profiler kept, which late in a long run fall short of the calls
    # (two of 25 bag launches were lost in one run; PERF.md §6).
    kept = sum(e.count for e in rows)
    if kept != iters:
        log(f"  profiler: kept {kept} of {iters} {match} launches")
    return total / kept


def profile_serving(engine, queries, n: int = 32) -> dict:
    """Where one unbudgeted query's time goes: device busy vs wall.

    Planning (``Engine.plan``: the host's block table; the anytime loop
    uploads the plan's tables once, before its clock starts) is timed
    apart, per query. The loop's wall time comes from a run without
    the profiler; the device busy time from a second, profiled run of the
    same plans.
    """
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.anytime import run_query_anytime

    engine.synchronize()
    t0 = time.perf_counter()
    plans = [engine.plan(q) for q in queries[:n]]
    engine.synchronize()
    plan_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    ranges = sum(run_query_anytime(engine, p).ranges_processed for p in plans)
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for p in plans:
            run_query_anytime(engine, p)
        torch.cuda.synchronize()
    rows = _device_events(prof)
    check(bool(rows), "profiler recorded no device time for the serving loop")
    busy_ms = sum(_self_device_us(e) for e in rows) / 1e3
    ops = sum(e.count for e in rows)
    top = sorted(rows, key=_self_device_us, reverse=True)[:6]
    return dict(
        queries=n, ranges=ranges, wall_ms=wall_ms, device_busy_ms=busy_ms,
        idle_share=1.0 - busy_ms / wall_ms, host_ms_per_range=wall_ms / ranges,
        device_busy_us_per_range=busy_ms * 1e3 / ranges,
        device_ops_per_range=ops / ranges, plan_ms_per_query=plan_ms / n,
        top=[dict(name=e.key[:80], us=_self_device_us(e), count=e.count) for e in top],
    )


def score_blocks_path(index, queries, parity: Parity, dev) -> dict:
    """The standalone kernels' own path: ``ops.score_blocks(impl="cuda")``.

    Each query's first range, all its blocks kept, through the scatter
    (int32 docids) and the decode plus scatter (packed docids), against
    the plain path, with the counters reset just before and read just
    after.
    """
    from repro_torch.core.range_daat import Engine
    from repro_torch.kernels.range_scorer import ops

    out = {}
    for fmt in ("int32", "packed"):
        eng = Engine(index, k=10, device=dev, impact_dtype="int8", docs_format=fmt)
        d = eng.dix
        args = []
        for q in queries:
            plan = eng.plan(q)
            blk = plan.blk_tab[int(plan.order_host[0])]
            safe = blk.clamp(min=0)
            kw = dict(pack_words=d.pack_words, pack_dir=d.pack_dir[safe],
                      pack_firsts=d.pack_first[safe]) if fmt == "packed" else {}
            args.append(((d.docs, d.impacts, d.blk_start[safe], d.blk_len[safe], blk >= 0,
                          d.range_starts[int(plan.order_host[0])]), kw))
        reset_launches()
        got = [ops.score_blocks(*a, s_pad=eng.s_pad, impl="cuda", docs_format=fmt, **kw)
               for a, kw in args]
        out[fmt] = read_launches()
        check_launches(out[fmt], {"scatter_accumulate": len(args),
                                  "unpack_locals": len(args) if fmt == "packed" else 0},
                       f"score_blocks {fmt} ({len(args)} ranges)")
        for i, ((a, kw), g) in enumerate(zip(args, got)):
            parity.record("scatter_accumulate", g,
                          ops.score_blocks(*a, s_pad=eng.s_pad, impl="torch",
                                           docs_format=fmt, **kw),
                          f"score_blocks {fmt} query {i}")
        del eng
    launches = {n: sum(out[f][n] for f in out) for n in ("scatter_accumulate",
                                                          "unpack_locals")}
    log(f"score_blocks path (impl='cuda', {len(queries)} first ranges per docid "
        f"format): equal to plain; launches {launches}")
    return launches


def batch_result_fields(r) -> tuple:
    """A ``BatchResult`` as ``observe``'s seven fields."""
    return (r.doc_ids.tolist(), r.scores.tolist(), r.postings, r.blocks,
            r.ranges_processed, r.exit_safe, r.exit_budget)


def batch_parity(index, queries, dev, n_plain: int | None = None) -> dict:
    """``BatchEngine`` on cuda == ``Engine.traverse`` per query, and ==
    ``BatchEngine`` on torch for the first ``n_plain`` (None: all), on all
    seven fields: unbudgeted, random per-query postings budgets, and random
    ``max_ranges`` caps (0 included), at ``MAX_BATCH``; one ``traverse``
    launch per chunk and nothing else."""
    import numpy as np
    from repro_torch.core.range_daat import Engine
    from repro_torch.serving import BatchEngine, BucketSpec

    kern = Engine(index, k=10, device=dev, impact_dtype="int8", docs_format="packed")
    plain = Engine(index, k=10, device=dev, impl="torch", impact_dtype="int8",
                   docs_format="packed")
    kb, pb = (BatchEngine(e, BucketSpec(max_batch=MAX_BATCH)) for e in (kern, plain))
    plans = kb.plan_many(queries)
    n = len(plans)
    rng = np.random.default_rng(13)
    out = {}
    first = None
    for label in ("unbudgeted", "budgets", "max_ranges"):
        budgets = maxr = None
        if label == "budgets":
            budgets = [int(rng.integers(1, max(r.postings, 1) + 1)) for r in first]
        elif label == "max_ranges":
            maxr = rng.integers(0, index.n_ranges + 1, size=n).tolist()
        before = kb.batches_run
        reset_launches()
        t0 = time.perf_counter()
        got = kb.run_batch(plans, budget_postings=budgets, max_ranges=maxr)
        kern_s = time.perf_counter() - t0
        launches = read_launches()
        chunks = kb.batches_run - before
        check_launches(launches, {"traverse": chunks}, f"batch parity {label}")
        m = n if n_plain is None else n_plain
        t0 = time.perf_counter()
        want = pb.run_batch(plans[:m], budget_postings=None if budgets is None else
                            budgets[:m], max_ranges=None if maxr is None else maxr[:m])
        plain_s = time.perf_counter() - t0
        first = first or got
        exits = {"safe": 0, "budget": 0, "exhausted": 0}
        for i, (g, w) in enumerate(zip(got, want)):
            check(batch_result_fields(g) == batch_result_fields(w),
                  f"batch parity {label} query {i}: cuda {batch_result_fields(g)} != "
                  f"torch {batch_result_fields(w)}")
        for i, (g, p) in enumerate(zip(got, plans)):
            gf = batch_result_fields(g)
            one = observe(kern, p, None if budgets is None else budgets[i],
                          None if maxr is None else maxr[i])
            check(gf == one, f"batch parity {label} query {i}: batch {gf} != "
                  f"Engine.traverse {one}")
            exits[g.exit_reason] += 1
        out[label] = dict(chunks=chunks, launches=launches, kernel_s=kern_s,
                          plain_s=plain_s, exits=exits,
                          ranges=sum(g.ranges_processed for g in got))
        log(f"batch parity {label}: {n} queries at max_batch {MAX_BATCH}, cuda == "
            f"Engine.traverse (and == torch for {m}) on all seven fields; {chunks} "
            f"chunks, traverse "
            f"launches {launches['traverse']}, others 0; exits {exits}, "
            f"{out[label]['ranges']} ranges; cuda {kern_s:.3f} s, torch {plain_s:.2f} s")
    return out


def served_fields(s) -> tuple:
    """A ``ServedQuery``'s rid, quanta and its result's seven fields."""
    return (s.rid, s.quanta) + batch_result_fields(s.result)


def inflight_parity(index, queries, dev, n_slots: int = BATCH, n_plain: int = 64) -> dict:
    """``InflightServer`` on cuda: every served query equal to
    ``Engine.traverse`` under its budget (the bitwise-resume invariant) at
    quantum 1 and 3, unbudgeted and under two fixed budgets; ``n_plain``
    queries at quantum 2 equal to the plain server (``impl="torch"`` on
    the card); one ``traverse`` launch per step and nothing else."""
    import numpy as np
    from repro_torch.core.range_daat import INT32_MAX, Engine
    from repro_torch.serving import BatchEngine, BucketSpec, InflightServer, SlaBudgeter

    class FixedBudgeter(SlaBudgeter):
        """Every admission gets the same postings cap."""

        cap = INT32_MAX

        def budgets(self, n, plans=None):
            return np.full(n, self.cap, np.int32)

    def server(eng, cap, quantum):
        budgeter = FixedBudgeter(sla_ms=float("inf"))
        budgeter.cap = cap
        return InflightServer(BatchEngine(eng, BucketSpec(max_batch=n_slots)), budgeter,
                              n_slots=n_slots, quantum=quantum)

    kern = Engine(index, k=10, device=dev, impact_dtype="int8", docs_format="packed")
    plain = Engine(index, k=10, device=dev, impl="torch", impact_dtype="int8",
                   docs_format="packed")
    plans = [kern.plan(q) for q in queries]
    whole = [observe(kern, p) for p in plans]
    post = sorted(w[2] for w in whole)
    caps = (INT32_MAX, post[len(post) // 2] // 2, post[len(post) // 4] // 4)
    out = {"caps": caps, "runs": {}}
    for quantum in (1, 3):
        for cap in caps:
            srv = server(kern, cap, quantum)
            reset_launches()
            t0 = time.perf_counter()
            served = srv.replay(queries)
            run_s = time.perf_counter() - t0
            launches = read_launches()
            ctx = f"in-flight parity quantum={quantum} cap={cap}"
            check_launches(launches, {"traverse": srv.steps_run}, ctx)
            check(sorted(s.rid for s in served) == list(range(len(queries))),
                  f"{ctx}: served rids differ from the submitted ones")
            exits = {"safe": 0, "budget": 0, "exhausted": 0}
            for s in served:
                want = whole[s.rid] if cap == INT32_MAX else observe(kern, plans[s.rid], cap)
                got = batch_result_fields(s.result)
                check(got == want, f"{ctx} query {s.rid}: in-flight {got} != "
                      f"Engine.traverse {want}")
                exits[s.result.exit_reason] += 1
            out["runs"][f"q{quantum} cap {cap}"] = dict(
                steps=srv.steps_run, launches=launches["traverse"], seconds=run_s,
                exits=exits, quanta=sum(s.quanta for s in served))
            log(f"{ctx}: {len(queries)} queries at {n_slots} slots == Engine.traverse on "
                f"all seven fields; {srv.steps_run} steps, traverse launches "
                f"{launches['traverse']}, others 0; exits {exits}; {run_s:.3f} s")
    kq, pq = (server(e, caps[1], 2) for e in (kern, plain))
    reset_launches()
    got = sorted(kq.replay(queries[:n_plain]), key=lambda s: s.rid)
    launches = read_launches()
    check_launches(launches, {"traverse": kq.steps_run}, "in-flight vs plain")
    t0 = time.perf_counter()
    want = sorted(pq.replay(queries[:n_plain]), key=lambda s: s.rid)
    plain_s = time.perf_counter() - t0
    check(kq.steps_run == pq.steps_run, f"in-flight vs plain: {kq.steps_run} steps vs "
          f"{pq.steps_run}")
    for g, w in zip(got, want):
        check(served_fields(g) == served_fields(w), f"in-flight vs plain query {g.rid}: "
              f"cuda {served_fields(g)} != torch {served_fields(w)}")
    out["plain"] = dict(queries=n_plain, steps=kq.steps_run, plain_s=plain_s)
    log(f"in-flight vs plain (quantum 2, cap {caps[1]}): {n_plain} queries, cuda == torch "
        f"on rid, quanta and all seven fields, {kq.steps_run} steps each; torch "
        f"{plain_s:.2f} s")
    return out


def sharded_fields(r) -> tuple:
    """Every ``ShardedResult`` field, as plain Python values."""
    return (r.doc_ids.tolist(), r.scores.tolist(), r.shard_postings.tolist(),
            r.shard_blocks.tolist(), r.shard_ranges.tolist(), r.shard_exit_reasons,
            r.fidelity_bound, r.exact)


def same_topk_up_to_ties(ids, vals, want_ids, want_vals) -> bool:
    """Equal scores, and equal documents above the k-th score (a document
    tying the k-th score may differ, as safe termination allows)."""
    if vals != want_vals:
        return False
    kth = vals[-1] if vals else 0
    return [d for d, v in zip(ids, vals) if v > kth] == \
        [d for d, v in zip(want_ids, want_vals) if v > kth]


def sharded_parity(index, queries, dev, n_plain: int = 64) -> dict:
    """``ShardedBatchEngine`` on cuda at ``max_batch`` BATCH, S = 2 and 4:
    equal to the plain sharded path on every ``ShardedResult`` field for
    ``n_plain`` queries (unbudgeted, budgeted, one shard down), the merged
    top-k equal to ``Engine.traverse`` (bitwise when both run exhaustively:
    ``safe_stop=False``, ``prune_blocks=False``; up to ties at the k-th
    score under safe stop and pruning), one ``traverse`` launch per chunk
    and nothing else."""
    import numpy as np
    from repro_torch.core.range_daat import Engine
    from repro_torch.serving import BucketSpec, ShardedBatchEngine, ShardedEngine

    kern = Engine(index, k=10, device=dev, impact_dtype="int8", docs_format="packed")
    plain = Engine(index, k=10, device=dev, impl="torch", impact_dtype="int8",
                   docs_format="packed")
    plans = [kern.plan(q) for q in queries]
    whole = [observe(kern, p) for p in plans]
    # Exhaustive (no safe stop, no block pruning): the merged top-k must
    # equal the single engine's bitwise. With pruning, a block whose bound
    # only ties θ is skipped, and the shards' lower θ keeps some such
    # blocks, so the lists agree up to ties at the k-th score.
    full = [kern.topk_docs(kern.traverse(p, safe_stop=False, prune_blocks=False).state)
            for p in plans]
    rng = np.random.default_rng(17)
    budgets = [int(rng.integers(1, max(w[2], 1) + 1)) for w in whole]
    out = {}
    for n_shards in (2, 4):
        ks = ShardedEngine(kern, n_shards)
        ps = ShardedEngine(plain, n_shards, shards=ks.shards)
        kb, pb = (ShardedBatchEngine(e, BucketSpec(max_batch=BATCH)) for e in (ks, ps))
        down = np.zeros(n_shards, bool)
        down[-1] = True
        forms = {"unbudgeted": {}, "budgeted": dict(budget_postings=budgets),
                 "shard down": dict(down_mask=down),
                 "exhaustive": dict(safe_stop=False, prune_blocks=False)}
        for label, kw in forms.items():
            ctx = f"sharded parity S={n_shards} {label}"
            before = kb.batches_run
            reset_launches()
            t0 = time.perf_counter()
            got = kb.run_batch(plans, **kw)
            kern_s = time.perf_counter() - t0
            launches = read_launches()
            chunks = kb.batches_run - before
            check_launches(launches, {"traverse": chunks}, ctx)
            row = dict(chunks=chunks, launches=launches["traverse"], kernel_s=kern_s,
                       exits={}, exact=sum(r.exact for r in got))
            for r in got:
                for reason in r.shard_exit_reasons:
                    row["exits"][reason] = row["exits"].get(reason, 0) + 1
            if label != "exhaustive":
                pkw = dict(kw, budget_postings=budgets[:n_plain]) if "budget_postings" in kw \
                    else kw
                t0 = time.perf_counter()
                want = pb.run_batch(plans[:n_plain], **pkw)
                row["plain_s"] = time.perf_counter() - t0
                for i, (g, w) in enumerate(zip(got, want)):
                    check(sharded_fields(g) == sharded_fields(w),
                          f"{ctx} query {i}: cuda {sharded_fields(g)} != torch "
                          f"{sharded_fields(w)}")
            if label == "unbudgeted":
                for i, (g, w) in enumerate(zip(got, whole)):
                    check(same_topk_up_to_ties(g.doc_ids.tolist(), g.scores.tolist(),
                                               w[0], w[1]),
                          f"{ctx} query {i}: merged top-k differs from Engine.traverse "
                          "beyond ties at the k-th score")
                row["bitwise_safe"] = sum(g.doc_ids.tolist() == w[0]
                                          for g, w in zip(got, whole))
            if label == "exhaustive":
                for i, (g, (ids, vals)) in enumerate(zip(got, full)):
                    check((g.doc_ids.tolist(), g.scores.tolist()) == (ids.tolist(),
                                                                      vals.tolist()),
                          f"{ctx} query {i}: merged top-k != Engine.traverse")
                    check(g.exact and g.fidelity_bound == 0, f"{ctx} query {i}: not exact")
            out[f"S={n_shards} {label}"] = row
            log(f"{ctx}: {len(plans)} queries at max_batch {BATCH}, cuda == torch on every "
                f"field for {n_plain if label != 'exhaustive' else 0}, "
                f"{'== Engine.traverse; ' if label in ('unbudgeted', 'exhaustive') else ''}"
                f"{chunks} chunks, traverse launches {launches['traverse']}, others 0; "
                f"shard exits {row['exits']}, exact {row['exact']}; cuda {kern_s:.3f} s"
                + (f", torch {row['plain_s']:.2f} s" if "plain_s" in row else ""))
    return out


def profile_batches(engine, queries, batch: int = BATCH, n: int = 64) -> dict:
    """Where an unbudgeted micro-batch's time goes, and the device's idle share.

    Per batch of ``batch`` queries: plan ms (``BatchEngine.plan_many``),
    dispatch ms (``run_batch`` up to the ``traverse`` launch's return:
    stacking, the chunk's one upload, the launch), device ms (the wait for the kernel after
    the launch returned) and read ms (the carry's copy back and its
    unpacking). Then ``n`` queries through a ``MicroBatchServer`` without
    the profiler (wall) and again with it (device busy).
    """
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving import BatchEngine, BucketSpec, MicroBatchServer, SlaBudgeter
    from repro_torch.serving import batch_engine

    bengine = BatchEngine(engine, BucketSpec(max_batch=batch))
    marks = []
    launch = batch_engine.traverse_lanes

    def timed(*a, **kw):
        t0 = time.perf_counter()
        out = launch(*a, **kw)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        marks.append((t0, t1, time.perf_counter()))
        return out

    rows = []
    batch_engine.traverse_lanes = timed
    try:
        for lo in range(0, n, batch):
            t0 = time.perf_counter()
            plans = bengine.plan_many(queries[lo:lo + batch])
            t1 = time.perf_counter()
            res = bengine.run_batch(plans)
            t2 = time.perf_counter()
            check(len(marks) == 1, f"{len(marks)} dispatches for one batch")
            (d0, d1, d2), = marks
            marks.clear()
            rows.append(dict(plan_ms=(t1 - t0) * 1e3, dispatch_ms=(d1 - t1) * 1e3,
                             device_ms=(d2 - d1) * 1e3, read_ms=(t2 - d2) * 1e3,
                             ranges=sum(r.ranges_processed for r in res),
                             slowest_lane=max(r.ranges_processed for r in res)))
    finally:
        batch_engine.traverse_lanes = launch

    def serve_window():
        server = MicroBatchServer(bengine, SlaBudgeter(sla_ms=float("inf")),
                                  max_batch=batch)
        return server.replay(queries[:n], batch_size=batch)

    serve_window()
    engine.synchronize()
    t0 = time.perf_counter()
    served = serve_window()
    wall_ms = (time.perf_counter() - t0) * 1e3
    before = bengine.batches_run
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        serve_window()
        torch.cuda.synchronize()
    dispatches = bengine.batches_run - before
    events = _device_events(prof)
    check(bool(events), "profiler recorded no device time for the batch window")
    # A dispatch uploads its chunk once (tables, caps and carries together).
    htod = sum(e.count for e in events if "HtoD" in e.key)
    check(htod <= dispatches, f"batch window: {htod} host-to-device copies over "
          f"{dispatches} dispatches")
    busy_ms = sum(_self_device_us(e) for e in events) / 1e3
    kern = [e for e in events if "traverse_kernel" in e.key]
    check(bool(kern), "profiler recorded no traverse_kernel in the batch window")
    ranges = sum(s.result.ranges_processed for s in served)
    mean = {key: sum(r[key] for r in rows) / len(rows)
            for key in ("plan_ms", "dispatch_ms", "device_ms", "read_ms")}
    return dict(
        batch=batch, queries=n, batches=rows, **{f"mean_{k}": v for k, v in mean.items()},
        wall_ms=wall_ms, device_busy_ms=busy_ms, idle_share=1.0 - busy_ms / wall_ms,
        ranges=ranges, dispatches=dispatches, htod_copies=htod,
        traverse_device_us=sum(_self_device_us(e) for e in kern),
        traverse_launches=sum(e.count for e in kern),
        traverse_us_per_lane_range=sum(_self_device_us(e) for e in kern) / ranges,
        top=[dict(name=e.key[:80], us=_self_device_us(e), count=e.count)
             for e in sorted(events, key=_self_device_us, reverse=True)[:6]],
    )


def _window_profile(run, dispatches) -> dict:
    """Wall time of ``run()`` without the profiler, then device busy time,
    host-to-device copies and ``traverse_kernel`` rows of a second, profiled
    ``run()``; ``dispatches()`` counts the launches so far."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    served = run()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    before = dispatches()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    n = dispatches() - before
    events = _device_events(prof)
    check(bool(events), "profiler recorded no device time for the window")
    kern = [e for e in events if "traverse_kernel" in e.key]
    check(bool(kern), "profiler recorded no traverse_kernel in the window")
    busy_ms = sum(_self_device_us(e) for e in events) / 1e3
    return dict(
        served=served, wall_ms=wall_ms, device_busy_ms=busy_ms,
        idle_share=1.0 - busy_ms / wall_ms, dispatches=n,
        htod_copies=sum(e.count for e in events if "HtoD" in e.key),
        traverse_device_us=sum(_self_device_us(e) for e in kern),
        traverse_launches=sum(e.count for e in kern),
        top=[dict(name=e.key[:80], us=_self_device_us(e), count=e.count)
             for e in sorted(events, key=_self_device_us, reverse=True)[:6]],
    )


def profile_inflight(engine, queries, n_slots: int = BATCH, n: int = 64,
                     quantum: int = 1) -> dict:
    """Where an unbudgeted in-flight step's time goes, and the idle share.

    Per step of ``n`` queries at ``n_slots`` slots: upload ms (the step's
    one ``upload_int32``), dispatch ms (the ``traverse`` launch's return),
    device ms (the wait for the kernel after it; this run waits before the
    lookahead planning, so the two do not overlap), plan ms (the lookahead
    planning) and read ms (the carry's one copy back). Then the window
    without the profiler (wall) and again with it (device busy,
    host-to-device copies per step).
    """
    import torch
    from repro_torch.core import range_daat
    from repro_torch.serving import BatchEngine, BucketSpec, InflightServer, SlaBudgeter
    from repro_torch.serving import inflight

    bengine = BatchEngine(engine, BucketSpec(max_batch=n_slots))
    rows, marks = [], {}
    upload, launch, read = (range_daat.upload_int32, range_daat.traverse_lanes,
                            inflight.carry_to_host)

    def timed_upload(arrays, device):
        t0 = time.perf_counter()
        out = upload(arrays, device)
        marks["upload"] = (t0, time.perf_counter())
        return out

    def timed_launch(*a, **kw):
        t0 = time.perf_counter()
        out = launch(*a, **kw)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        marks["launch"] = (t0, t1, time.perf_counter())
        return out

    def timed_read(carry):
        t0 = time.perf_counter()
        out = read(carry)
        t1 = time.perf_counter()
        (u0, u1), (l0, l1, l2) = marks.pop("upload"), marks.pop("launch")
        rows.append(dict(upload_ms=(u1 - u0) * 1e3, dispatch_ms=(l1 - l0) * 1e3,
                         device_ms=(l2 - l1) * 1e3, plan_ms=(t0 - l2) * 1e3,
                         read_ms=(t1 - t0) * 1e3))
        return out

    def server():
        return InflightServer(bengine, SlaBudgeter(sla_ms=float("inf")), n_slots=n_slots,
                              quantum=quantum)

    range_daat.upload_int32, range_daat.traverse_lanes = timed_upload, timed_launch
    inflight.carry_to_host = timed_read
    try:
        timed = server()
        timed.replay(queries[:n])
    finally:
        range_daat.upload_int32, range_daat.traverse_lanes = upload, launch
        inflight.carry_to_host = read
    check(len(rows) == timed.steps_run, f"{len(rows)} timed steps of {timed.steps_run}")
    servers = []

    def run():
        servers.append(server())
        return servers[-1].replay(queries[:n])

    win = _window_profile(run, lambda: sum(x.steps_run for x in servers))
    served = win.pop("served")
    # A step uploads its slots once (tables, caps and carry together).
    check(win["htod_copies"] <= win["dispatches"], f"in-flight window: "
          f"{win['htod_copies']} host-to-device copies over {win['dispatches']} steps")
    mean = {key: sum(r[key] for r in rows) / len(rows)
            for key in ("upload_ms", "dispatch_ms", "device_ms", "plan_ms", "read_ms")}
    ranges = sum(s.result.ranges_processed for s in served)
    return dict(slots=n_slots, quantum=quantum, queries=n, steps=len(rows),
                **{f"mean_{k}": v for k, v in mean.items()}, **win, ranges=ranges,
                htod_per_step=win["htod_copies"] / max(win["dispatches"], 1),
                traverse_us_per_step=win["traverse_device_us"] / max(
                    win["traverse_launches"], 1))


def profile_sharded(engine, queries, n_shards: int = SHARDS, batch: int = BATCH,
                    n: int = 64) -> dict:
    """Where an unbudgeted sharded micro-batch's time goes, and the idle share.

    Per batch of ``batch`` queries over ``n_shards`` shards: plan ms
    (``plan_many``), shard-plan ms (``ShardedEngine.shard_plan`` per query),
    dispatch ms (``sharded_batched_traverse`` up to its return: the one
    upload, the launch, the merge's device operations queued), device ms
    (the wait after it) and read ms (the one copy back and the results).
    Then ``n`` queries through a ``MicroBatchServer`` without the profiler
    (wall) and again with it (device busy, host-to-device copies).
    """
    import torch
    from repro_torch.serving import (
        BucketSpec, MicroBatchServer, ShardedBatchEngine, ShardedEngine, ShardedSlaBudgeter)
    from repro_torch.serving import sharded

    seng = ShardedEngine(engine, n_shards)
    bengine = ShardedBatchEngine(seng, BucketSpec(max_batch=batch))
    marks, shard_plan_s = [], [0.0]
    dispatch, shard_plan = sharded.sharded_batched_traverse, seng.shard_plan

    def timed_dispatch(*a, **kw):
        t0 = time.perf_counter()
        out = dispatch(*a, **kw)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        marks.append((t0, t1, time.perf_counter()))
        return out

    def timed_shard_plan(*a, **kw):
        t0 = time.perf_counter()
        out = shard_plan(*a, **kw)
        shard_plan_s[0] += time.perf_counter() - t0
        return out

    rows = []
    sharded.sharded_batched_traverse, seng.shard_plan = timed_dispatch, timed_shard_plan
    try:
        for lo in range(0, n, batch):
            t0 = time.perf_counter()
            plans = bengine.plan_many(queries[lo:lo + batch])
            t1 = time.perf_counter()
            shard_plan_s[0] = 0.0
            res = bengine.run_batch(plans)
            t2 = time.perf_counter()
            check(len(marks) == 1, f"{len(marks)} dispatches for one sharded batch")
            (d0, d1, d2), = marks
            marks.clear()
            rows.append(dict(plan_ms=(t1 - t0) * 1e3, shard_plan_ms=shard_plan_s[0] * 1e3,
                             dispatch_ms=(d1 - d0) * 1e3, device_ms=(d2 - d1) * 1e3,
                             read_ms=(t2 - d2) * 1e3,
                             stage_ms=(d0 - t1) * 1e3 - shard_plan_s[0] * 1e3,
                             lane_ranges=int(sum(r.shard_ranges.sum() for r in res))))
    finally:
        sharded.sharded_batched_traverse = dispatch
        del seng.shard_plan

    def run():
        server = MicroBatchServer(bengine, ShardedSlaBudgeter(sla_ms=float("inf"),
                                                              n_shards=n_shards),
                                  max_batch=batch)
        return server.replay(queries[:n], batch_size=batch)

    win = _window_profile(run, lambda: bengine.batches_run)
    served = win.pop("served")
    check(win["htod_copies"] <= win["dispatches"], f"sharded window: "
          f"{win['htod_copies']} host-to-device copies over {win['dispatches']} dispatches")
    mean = {key: sum(r[key] for r in rows) / len(rows)
            for key in ("plan_ms", "shard_plan_ms", "stage_ms", "dispatch_ms", "device_ms",
                        "read_ms")}
    lane_ranges = int(sum(s.result.shard_ranges.sum() for s in served))
    return dict(shards=n_shards, batch=batch, queries=n, batches=rows,
                **{f"mean_{k}": v for k, v in mean.items()}, **win,
                lane_ranges=lane_ranges,
                traverse_us_per_lane_range=win["traverse_device_us"] / max(lane_ranges, 1))


class StepBytes:
    """Bytes a range step must move, from host copies of the block rows.

    Per listed block: a padding id (-1) costs its 4-byte id alone; a valid
    block its id, rest bound and max impact (12 B), which decide whether
    it is kept (max impact plus rest beats θ); a kept block also its row
    (start and length, plus the directory and first docid when packed)
    and its postings (impacts, and docids or packed words). The
    accumulator never leaves the chip.
    """

    def __init__(self, dix, docs_format: str):
        from repro_torch.kernels.range_scorer import ref

        self.packed = docs_format == "packed"
        self.lens = dix.blk_len.cpu().numpy()
        self.maximp = dix.blk_maximp.cpu().numpy()
        self.widths = ref.unpack_dir(dix.pack_dir)[1].cpu().numpy() if self.packed \
            else None
        self.imp_size = dix.impacts.element_size()

    def __call__(self, blk, rest, theta: int) -> int:
        import numpy as np

        safe = np.clip(blk, 0, None)
        valid = blk >= 0
        keep = valid & (self.maximp[safe] + rest > theta)
        lens = self.lens[safe][keep].astype(np.int64)
        row = 4 * 2 + (4 * 2 if self.packed else 0)  # start, len (+ dir, first)
        docs = (int(((lens * self.widths[safe][keep] + 31) // 32).sum()) * 4
                if self.packed else int(lens.sum()) * 4)
        return (blk.shape[0] * 4 + int(valid.sum()) * 8 + int(keep.sum()) * row
                + int(lens.sum()) * self.imp_size + docs)


def step_bytes(dix, state, blk, rest, docs_format: str) -> int:
    """One range_step's bytes: its step (``StepBytes``), the state in and
    out, and the range start."""
    k = state.vals.shape[0]
    return (StepBytes(dix, docs_format)(blk.cpu().numpy(), rest.cpu().numpy(),
                                       int(state.vals[-1])) + 2 * (2 * k + 2) * 4 + 4)


def traverse_bytes(eng, lanes, dix=None) -> tuple[int, int, int]:
    """(bytes, ranges scored, the slowest lane's ranges) of one
    ``traverse`` call, from a step-by-step replay of each lane with the
    plain range step: per scored range its step (``StepBytes``), its order
    entry and range start, per decision its bound entry, per lane its
    carry in and out and its two caps. The state stays on chip. ``dix``
    (default the engine's) may be stacked shards: lane n replays on
    shard n % S."""
    from repro_torch.kernels.range_scorer import ref

    dix = eng.dix if dix is None else dix
    blk, rest, order, bounds, budget, maxr, carry = lanes
    blk_h, rest_h = blk.cpu().numpy(), rest.cpu().numpy()
    order_h, bounds_h = order.cpu().numpy(), bounds.cpu().numpy()
    rows = ([ref.shard_row(dix, s) for s in range(dix.range_starts.shape[0])]
            if dix.range_starts.dim() == 2 else [dix])
    costs = [StepBytes(row, eng.docs_format) for row in rows]
    k, (N, R) = eng.k, order_h.shape
    total = N * (2 * ref.carry_width(k) * 4 + 8)
    scored = slowest = 0
    for n in range(N):
        row, cost = rows[n % len(rows)], costs[n % len(rows)]
        state = ref.state_views(carry[n, : 2 * k + 2], k)
        i = int(carry[n, 2 * k + 2])
        while i < R:
            th, postings = ref.theta_postings(state)
            total += 4  # bound[i]
            if (bounds_h[n, i] <= th and th > 0) or postings >= int(budget[n]) \
                    or i >= int(maxr[n]):
                break
            r = int(order_h[n, i])
            total += 4 + cost(blk_h[n, r], rest_h[n, r], th) + 4  # order[i], range start
            state = ref.range_step_ref(row, state, blk[n, r], rest[n, r],
                                       row.range_starts[r], s_pad=eng.s_pad, k=k,
                                       docs_format=eng.docs_format)
            i += 1
            scored += 1
        slowest = max(slowest, i - int(carry[n, 2 * k + 2]))
    return total, scored, slowest


class TimingInputs:
    """The main-path shapes the kernel timings and the phase timer share: the
    widest first range of the log for the range kernels (int8/packed, from
    an empty state), an unbudgeted micro-batch of the log's first BATCH
    queries for ``traverse``, and the same queries over SHARDS stacked
    shards (BATCH * SHARDS lanes)."""

    def __init__(self, index, queries, dev):
        import numpy as np
        from repro_torch.core.range_daat import (
            INT32_MAX, Engine, batched_init_carry, carry_buffer, upload_int32)
        from repro_torch.serving import BucketSpec, ShardedEngine, stack_plans

        self.eng = eng = Engine(index, k=10, device=dev, impact_dtype="int8",
                                docs_format="packed")
        self.plans = plans = [eng.plan(q) for q in queries]
        self.plan = plan = max(
            plans, key=lambda p: int((p.blk_tab[int(p.order_host[0])] >= 0).sum()))
        self.r = r = int(plan.order_host[0])
        self.blk = plan.blk_tab[r]
        self.rs = eng.dix.range_starts[r]
        self.state = eng.init_state()
        self.step_args = (eng.dix, self.state, self.blk, plan.rest_tab[r], self.rs)
        self.kw = dict(s_pad=eng.s_pad, k=eng.k, docs_format="packed")
        spec = BucketSpec()
        batch = plans[:BATCH]
        self.width = width = max(spec.width_bucket(p.blk_tab_host.shape[1]) for p in batch)
        bp = stack_plans(batch, width, BATCH)
        bud, mr, carry = upload_int32(([INT32_MAX] * BATCH, [INT32_MAX] * BATCH,
                                       carry_buffer(batched_init_carry(BATCH, eng.k))), dev)
        self.lanes = (bp.blk_tab, bp.rest_tab, bp.order, bp.ordered_bounds, bud, mr, carry)
        self.seng = seng = ShardedEngine(eng, SHARDS)
        tabs = [np.stack(t) for t in zip(*[seng.shard_plan(p, width) for p in batch])]
        n_lanes = BATCH * SHARDS
        self.slanes = upload_int32(
            [t.reshape(n_lanes, *t.shape[2:]) for t in tabs]
            + [[INT32_MAX] * n_lanes, [INT32_MAX] * n_lanes,
               carry_buffer(batched_init_carry(n_lanes, eng.k))], dev)


def kernel_timings(index, queries, parity: Parity, dev, ti: TimingInputs) -> dict:
    """Each kernel at a main-path shape (``TimingInputs``); ``traverse`` also
    through its caller ``traverse_lanes``, where the dry run's shape rule
    sits, and the rule's own host cost (one ``is_abstract`` a call)."""
    import numpy as np
    import torch
    from repro_torch.core.range_daat import Engine, traverse_lanes
    from repro_torch.kernels._abstract import is_abstract
    from repro_torch.kernels.range_scorer import kernel, ref

    eng, plan, r, blk, rs = ti.eng, ti.plan, ti.r, ti.blk, ti.rs
    raw = Engine(index, k=10, device=dev, impact_dtype="int8")
    safe = blk.clamp(min=0)
    starts, lens = eng.dix.blk_start[safe], eng.dix.blk_len[safe]
    keep = blk >= 0  # the first range is scored before θ can prune
    B, s_pad = int(blk.shape[0]), eng.s_pad

    # scatter_accumulate on the gathered (local id, value) lanes.
    local, vals = ref.gather_block_postings(raw.dix.docs, raw.dix.impacts, starts,
                                            lens, keep, rs)
    parity.record("scatter_accumulate", kernel.scatter_accumulate(local, vals, s_pad),
                  ref.scatter_accumulate_ref(local, vals, s_pad), "timing inputs")
    tgt = torch.where((local < 0) | (local >= s_pad), s_pad, local).to(torch.int64)
    lib_acc = torch.zeros(s_pad + 1, dtype=torch.int32, device=local.device)

    def library():
        lib_acc.zero_()
        lib_acc.index_add_(0, tgt, vals)

    library()
    check(torch.equal(lib_acc[:s_pad], ref.scatter_accumulate_ref(local, vals, s_pad)),
          "index_add_ yardstick computes another function")
    P = local.numel()
    wrapper = functools.partial(kernel.scatter_accumulate, local, vals, s_pad)
    plain = functools.partial(ref.scatter_accumulate_ref, local, vals, s_pad)
    scatter = dict(
        shape=f"P={P} (B={B}) s_pad={s_pad}",
        ms=time_ms(wrapper), plain_ms=time_ms(plain), library_ms=time_ms(library),
        kernel_device_us=device_us(wrapper, "scatter_accumulate_kernel"),
        wrapper_device_us=device_us(wrapper), plain_device_us=device_us(plain),
        library_device_us=device_us(library),
        library_fill_device_us=device_us(lib_acc.zero_),
        bytes=P * 8 + s_pad * 4,
    )

    # unpack_locals on the same blocks' directory rows.
    args = (eng.dix.pack_words, starts, lens, eng.dix.pack_dir[safe],
            eng.dix.pack_first[safe], keep, rs)
    parity.record("unpack_locals", kernel.unpack_locals(*args),
                  ref.unpack_locals_ref(*args), "timing inputs")
    _, widths = ref.unpack_dir(args[3])
    valid = (keep & (starts >= 0)).cpu().numpy()
    words = ((lens.cpu().numpy().astype(np.int64) * widths.cpu().numpy() + 31) // 32)
    wrapper = functools.partial(kernel.unpack_locals, *args)
    plain = functools.partial(ref.unpack_locals_ref, *args)
    unpack = dict(
        shape=f"B={B}",
        ms=time_ms(wrapper), plain_ms=time_ms(plain), library_ms=None,
        kernel_device_us=device_us(wrapper, "unpack_locals_kernel"),
        wrapper_device_us=device_us(wrapper), plain_device_us=device_us(plain),
        library_device_us=None,
        bytes=int(words[valid].sum()) * 4 + B * 17 + B * 128 * 4,
    )
    # range_step: the whole first range, from an empty state (int8/packed).
    state, step_args, kw = ti.state, ti.step_args, ti.kw
    parity.record_state(kernel.range_step(*step_args, **kw),
                        ref.range_step_ref(*step_args, **kw), "timing inputs")
    wrapper = functools.partial(kernel.range_step, *step_args, **kw)
    plain = functools.partial(ref.range_step_ref, *step_args, **kw)
    step = dict(
        shape=f"B={B} s_pad={s_pad} k={eng.k} ({kernel.acc_placement(s_pad)} acc)",
        ms=time_ms(wrapper), plain_ms=time_ms(plain), library_ms=None,
        kernel_device_us=device_us(wrapper, "range_step_kernel"),
        wrapper_device_us=device_us(wrapper), plain_device_us=device_us(plain),
        library_device_us=None,
        bytes=step_bytes(eng.dix, state, blk, plan.rest_tab[r], "packed"),
    )
    # traverse: one unbudgeted micro-batch of the batch serving window's
    # size (the log's first BATCH queries, stacked at their widest bucket).
    lanes, width = ti.lanes, ti.width
    parity.record_carry(kernel.traverse(eng.dix, *lanes, **kw),
                        ref.traverse_ref(eng.dix, *lanes, **kw), eng.k, "timing inputs")
    nbytes, scored, slowest = traverse_bytes(eng, lanes)
    wrapper = functools.partial(kernel.traverse, eng.dix, *lanes, **kw)
    plain = functools.partial(ref.traverse_ref, eng.dix, *lanes, **kw)
    caller = functools.partial(traverse_lanes, eng.dix, *lanes, **kw, impl="cuda")
    t0, n_rule = time.perf_counter(), 100_000
    for _ in range(n_rule):
        is_abstract(lanes[-1])
    rule_us = (time.perf_counter() - t0) / n_rule * 1e6
    trav = dict(
        shape=(f"N={BATCH} R={index.n_ranges} B={width} s_pad={s_pad} k={eng.k} "
               f"({kernel.acc_placement(s_pad, 'traverse')} acc), {scored} ranges"),
        ms=time_ms(wrapper, 100), plain_ms=time_ms(plain, 2, warmup=1), library_ms=None,
        caller_ms=time_ms(caller, 100), rule_us=rule_us,
        kernel_device_us=device_us(wrapper, "traverse_kernel", 50),
        wrapper_device_us=device_us(wrapper, None, 50),
        plain_device_us=device_us(plain, None, 2), library_device_us=None,
        bytes=nbytes, ranges=scored, slowest_lane_ranges=slowest,
    )
    # traverse at the sharded window's shape: the same BATCH queries over
    # SHARDS stacked shards, BATCH * SHARDS lanes in one launch.
    seng, slanes = ti.seng, ti.slanes
    parity.record_carry(kernel.traverse(seng.dix, *slanes, **kw),
                        ref.traverse_ref(seng.dix, *slanes, **kw), eng.k,
                        "sharded timing inputs")
    nbytes, scored, slowest = traverse_bytes(eng, slanes, seng.dix)
    wrapper = functools.partial(kernel.traverse, seng.dix, *slanes, **kw)
    plain = functools.partial(ref.traverse_ref, seng.dix, *slanes, **kw)
    strav = dict(
        shape=(f"N={BATCH}x{SHARDS} shards R_max={seng.r_max} B={width} s_pad={s_pad} "
               f"k={eng.k}, {scored} ranges"),
        ms=time_ms(wrapper, 100), plain_ms=time_ms(plain, 2, warmup=1), library_ms=None,
        kernel_device_us=device_us(wrapper, "traverse_kernel", 50),
        wrapper_device_us=device_us(wrapper, None, 50),
        plain_device_us=device_us(plain, None, 2), library_device_us=None,
        bytes=nbytes, ranges=scored, slowest_lane_ranges=slowest,
    )
    for d in (scatter, unpack, step, trav, strav):
        d["bound_ms"] = d["bytes"] / HBM_BYTES_PER_S * 1e3
    return {"scatter_accumulate": scatter, "unpack_locals": unpack, "range_step": step,
            "traverse": trav, "traverse_sharded": strav}


def sm_clock_mhz(fn, seconds: float = 1.5) -> dict:
    """The SM clock ``nvidia-smi`` reads (every 100 ms) while ``fn`` runs on
    the card in a loop: the median sample, in MHz, and the card's maximum."""
    import torch

    proc = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader,nounits",
         "-lms", "100"], stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
    finally:
        proc.terminate()
        out, _ = proc.communicate(timeout=60)
    samples = []
    for line in out.splitlines():
        try:
            samples.append(tuple(float(x) for x in line.split(",")[:2]))
        except ValueError:
            continue
    check(bool(samples), "nvidia-smi read no SM clock beside the phase timer")
    sm = sorted(x for x, _ in samples)
    return dict(sm_mhz=sm[len(sm) // 2], max_mhz=samples[0][1], samples=len(sm))


def phase_table(clk, steps: float, mhz: float) -> dict:
    """Cycles and microseconds per step of each phase, from summed clocks."""
    from repro_torch.kernels.range_scorer import kernel

    cyc = {name: float(clk[i]) / max(steps, 1) for i, name in enumerate(kernel.PHASES)}
    cyc["total"] = sum(cyc.values())
    return dict(steps=steps, cycles=cyc, us={n: c / mhz for n, c in cyc.items()})


def phase_timings(ti: TimingInputs, parity: Parity, dev) -> dict:
    """The range step's phases timed by thread 0's ``clock64`` (the kernels'
    timed variant), at ``TimingInputs``' shapes: ``range_step`` warm (the
    same launch repeated) and cold (the 50 MB L2 flushed before each launch),
    ``traverse`` at BATCH lanes and at BATCH x SHARDS lanes, per step of the
    slowest lane and per step over every lane. Cycles become microseconds at
    the SM clock ``nvidia-smi`` reads while the timed kernel runs."""
    import torch
    from repro_torch.kernels.range_scorer import kernel, ref

    eng, kw = ti.eng, ti.kw
    new, _ = kernel.range_step_phases(*ti.step_args, **kw)
    parity.record_state(new, ref.range_step_ref(*ti.step_args, **kw), "timed variant")
    clock = sm_clock_mhz(lambda: kernel.range_step_phases(*ti.step_args, **kw))
    mhz = clock["sm_mhz"]
    out = dict(clock=clock)
    n = 50
    total = torch.zeros(len(kernel.PHASES) + 1, dtype=torch.int64, device=dev)
    for _ in range(n):
        total += kernel.range_step_phases(*ti.step_args, **kw)[1]
    out["range_step warm"] = phase_table(total.cpu().tolist(), n, mhz)
    flush = torch.empty(32 * 2**20, dtype=torch.int32, device=dev)  # 128 MiB
    total.zero_()
    for _ in range(20):
        flush.fill_(1)
        total += kernel.range_step_phases(*ti.step_args, **kw)[1]
    out["range_step cold"] = phase_table(total.cpu().tolist(), 20, mhz)
    for label, dix, lanes in (("traverse", eng.dix, ti.lanes),
                              ("traverse sharded", ti.seng.dix, ti.slanes)):
        carry, clk = kernel.traverse_phases(dix, *lanes, **kw)
        parity.record_carry(carry, ref.traverse_ref(dix, *lanes, **kw), eng.k,
                            f"{label} timed variant")
        total = torch.zeros_like(clk)
        for _ in range(10):
            total += kernel.traverse_phases(dix, *lanes, **kw)[1]
        rows = (total // 10).cpu().tolist()
        slow = max(rows, key=lambda row: (row[-1], sum(row[:-1])))
        out[f"{label} slowest lane"] = phase_table(slow[:-1], slow[-1], mhz)
        every = [sum(col) for col in zip(*rows)]
        out[f"{label} every lane"] = phase_table(every[:-1], every[-1], mhz)
    for label, row in out.items():
        if label == "clock":
            continue
        log(f"phase timer {label} ({row['steps']:.0f} steps, {mhz:.0f} MHz): per step "
            + ", ".join(f"{n} {row['cycles'][n]:.0f} cyc / {row['us'][n]:.3f} us"
                        for n in (*kernel.PHASES, "total")))
    # The dependency floor: the step's dependent global rounds times one cold
    # load, read off the cold range_step's zero and directory phases: the
    # block ids, then their rows (two rounds), with the zero pass beside
    # them. Both kernels wait on three rounds (ids, rows, postings).
    cold = (out["range_step cold"]["cycles"]["zero"]
            + out["range_step cold"]["cycles"]["directory"]) / 2
    out["cold_load_cycles"] = cold
    out["dependency_floor_us"] = DEP_ROUNDS * cold / mhz
    log(f"phase timer: one cold load ~{cold:.0f} cycles ({cold / mhz:.3f} us); "
        f"dependency floor per step: {DEP_ROUNDS} rounds = "
        f"{out['dependency_floor_us']:.3f} us")
    return out


def ptxas_summary(lines: list[str]) -> list[str]:
    """``ptxas_lines`` folded to one line per kernel: its variants, their
    register range, shared memory and the most bytes any of them spills."""
    import re

    kernels: dict = {}
    for line in lines:
        name, _, rest = line.partition("<")
        k = kernels.setdefault(name, {"variants": set(), "regs": [], "spill": 0, "smem": set()})
        k["variants"].add(rest.split(">")[0])
        m = re.search(r"Used (\d+) registers", line)
        if m:
            k["regs"].append(int(m.group(1)))
        m = re.search(r"(\d+) bytes smem", line)
        if m:
            k["smem"].add(int(m.group(1)))
        for b in re.findall(r"(\d+) bytes spill", line):
            k["spill"] = max(k["spill"], int(b))
    return [f"{name}: {len(k['variants'])} variants, {min(k['regs'], default=0)}-"
            f"{max(k['regs'], default=0)} registers, {sorted(k['smem'])} bytes static smem, "
            f"at most {k['spill']} bytes spilled" for name, k in kernels.items()]


def ptxas_lines(build_log: str) -> list[str]:
    """``-Xptxas -v``'s registers, shared memory and spills per kernel, one
    line each, the template flags shown as <...>."""
    import re

    lines, name = [], None
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            mangled = m.group(1)
            base = re.search(r"\d+([a-z_]+_kernel)", mangled)
            flags = "".join(re.findall(r"Lb([01])E", mangled))
            name = f"{base.group(1) if base else mangled}<{','.join(flags)}>"
        elif name and ("spill" in line or "Used" in line):
            lines.append(f"{name}: {line.split(':', 1)[-1].strip()}")
    return lines


# ----------------------------------------------------------------------- main


# ------------------------------------------------------------ artifact phase


ARTIFACT_DIR = ROOT / ".cache" / "chip_smoke_artifacts"  # git-ignored; removed after
CHAIN_DIR = ROOT / ".cache" / "chip_smoke_chain"
CHAIN_QUERIES = 64


def _dir_bytes(path) -> int:
    return sum(f.stat().st_size for f in Path(path).rglob("*") if f.is_file())


def build_chain(src: str, cfg: dict, out_dir: str) -> dict:
    """Worker: a delta chain at ``cfg``'s size and what it must equal.

    A base index (``clustered``, int8 impacts, packed docids) saved as an
    artifact, one ``append_index`` of a delta corpus of a tenth of its
    documents, the chain's ``compact``, and a fresh build of
    ``concat_corpora`` at the chain's arrangement, shared quantizer and
    frozen statistics, saved too. Returns the paths, fingerprints, times
    and a query log over the concatenated corpus.
    """
    import os

    sys.path.insert(0, src)
    from repro_torch import index_io
    from repro_torch.core.clustered_index import build_index
    from repro_torch.data.synth import concat_corpora, make_corpus, make_query_log

    shape = dict(n_terms=cfg["n_terms"], n_topics=cfg["n_topics"],
                 mean_doc_len=cfg["mean_doc_len"])
    base_c = make_corpus(n_docs=cfg["n_docs"], seed=0, **shape)
    delta_c = make_corpus(n_docs=cfg["n_docs"] // 10, seed=1, **shape)
    t0 = time.perf_counter()
    base = build_index(base_c, n_ranges=cfg["n_ranges"], strategy="clustered", bits=8,
                       seed=0)
    paths = {n: os.path.join(out_dir, n) for n in ("base", "head", "compact", "fresh")}
    t1 = time.perf_counter()
    index_io.save_index(base, paths["base"], impact_dtype="int8", docs_format="packed",
                        overwrite=True)
    t2 = time.perf_counter()
    ext = index_io.append_index(paths["base"], delta_c, paths["head"], n_ranges=2, seed=1,
                                overwrite=True)
    t3 = time.perf_counter()
    index_io.compact(paths["head"], paths["compact"], overwrite=True)
    t4 = time.perf_counter()
    cat = concat_corpora(base_c, delta_c)
    fresh = build_index(cat, arrangement=ext.arrangement, quantizer=base.quantizer,
                        stats=base.stats, params=base.bm25)
    index_io.save_index(fresh, paths["fresh"], impact_dtype="int8", overwrite=True)
    return dict(
        paths=paths, base_docs=base.n_docs, delta_docs=delta_c.n_docs,
        fingerprints=dict(extended=ext.fingerprint(), fresh=fresh.fingerprint()),
        delta_bytes=_dir_bytes(paths["head"]), base_bytes=_dir_bytes(paths["base"]),
        build_s=t1 - t0, save_s=t2 - t1, append_s=t3 - t2, compact_s=t4 - t3,
        terms=make_query_log(cat, n_queries=CHAIN_QUERIES, seed=QUERY_SEED).terms,
    )


def chain_phase(job, dev) -> dict:
    """The chain head (``load_chain``), its compaction and the fresh build
    of the concatenated corpus, each served on the card from its artifact:
    equal fingerprints, and every ``observe_query`` field equal for every
    query, unbudgeted and budgeted (one ``traverse`` launch per query)."""
    import numpy as np
    from repro_torch import index_io
    from repro_torch.core.range_daat import Engine

    import shutil

    out = job.get()
    paths = out["paths"]
    check(out["fingerprints"]["extended"] == out["fingerprints"]["fresh"],
          "chain: extended index != fresh build of the concatenated corpus")
    t0 = time.perf_counter()
    head = index_io.load_chain(paths["head"])
    load_chain_s = time.perf_counter() - t0
    check(index_io.validate_artifact(paths["head"]) == [], "chain: head invalid")
    engines = {name: Engine(idx, k=10, device=dev, impact_dtype="int8",
                            docs_format="packed")
               for name, idx in (("chain", head),
                                 ("compact", index_io.load_index(paths["compact"])),
                                 ("fresh", index_io.load_index(paths["fresh"])))}
    fps = {n: e.index.fingerprint() for n, e in engines.items()}
    check(len(set(fps.values())) == 1, f"chain: fingerprints differ {fps}")
    queries = [out["terms"][i] for i in range(out["terms"].shape[0])]
    rng = np.random.default_rng(17)
    reset_launches()
    n_new, n_budget = 0, 0
    base_docs = out["base_docs"]
    for i, q in enumerate(queries):
        got = {n: observe(e, e.plan(q)) for n, e in engines.items()}
        check(got["chain"] == got["compact"] == got["fresh"],
              f"chain query {i}: chain/compact/fresh differ {got}")
        b = int(rng.integers(1, max(got["chain"][2], 1) + 1))
        gotb = {n: observe(e, e.plan(q), b) for n, e in engines.items()}
        check(gotb["chain"] == gotb["compact"] == gotb["fresh"],
              f"chain query {i} budget {b}: chain/compact/fresh differ {gotb}")
        n_new += sum(d >= base_docs for d in got["chain"][0])
        n_budget += gotb["chain"][6]
    launches = read_launches()
    check_launches(launches, {"traverse": 6 * len(queries)}, "chain phase")
    res = dict(base_docs=base_docs, delta_docs=out["delta_docs"],
               fingerprint=fps["chain"], load_chain_s=load_chain_s,
               launches=launches, new_docs_served=n_new, budget_exits=n_budget,
               **{k: out[k] for k in ("build_s", "save_s", "append_s", "compact_s",
                                      "base_bytes", "delta_bytes")})
    log(f"chain: base {base_docs} docs + append {out['delta_docs']} docs (delta "
        f"artifact {out['delta_bytes']} B beside the base's {out['base_bytes']} B; save "
        f"{out['save_s']:.2f} s, append {out['append_s']:.2f} s, compact "
        f"{out['compact_s']:.2f} s in a worker); load_chain {load_chain_s:.2f} s; "
        f"chain == compact == fresh build of concat_corpora on the card: fingerprint "
        f"{fps['chain']}, {len(queries)} queries on every observe_query field, "
        f"unbudgeted and budgeted ({n_budget} budget exits, {n_new} appended docs "
        f"served); traverse launches {launches['traverse']}, others 0")
    res["journal"] = journal_phase(paths, queries, dev)
    shutil.rmtree(CHAIN_DIR, ignore_errors=True)
    return res


def artifact_phase(index, queries, engine, dev, n: int = 64) -> dict:
    """The scale index through ``index_io`` and back onto the card (the
    int8/packed artifact and its shard artifact stay for the mesh phase).

    ``save_index`` (int8, packed) and ``save_shards`` (S = ``SHARDS``, with
    the source fingerprint); ``Engine.from_artifact`` (eager load) and an
    engine over ``load_index(mmap=True)``, ``BatchEngine.from_artifact`` and
    ``ShardedEngine.from_artifact(shards_path=...)`` on the card, each equal
    to the in-memory ``engine`` for ``n`` queries, unbudgeted and budgeted:
    ``observe_query`` fields and the anytime loop (one ``range_step`` per
    range), ``BatchResult`` (one ``traverse`` per chunk), ``ShardedResult``
    (one ``traverse`` per chunk). Stale and unverifiable shard artifacts are
    refused; ``repack`` int32 -> packed keeps the fingerprint and the
    results. Times: save, load with and without mmap (fingerprint check
    included), the ``DeviceIndex`` upload, and the cold start from the
    ``from_artifact`` call to the first answered query.
    """
    import shutil

    import numpy as np
    import torch
    from repro_torch import index_io
    from repro_torch.core.clustered_index import build_index, shard_device_index
    from repro_torch.core.range_daat import Engine
    from repro_torch.data.synth import make_corpus
    from repro_torch.serving import (
        BatchEngine, BucketSpec, ShardedBatchEngine, ShardedEngine)

    shutil.rmtree(ARTIFACT_DIR, ignore_errors=True)
    ARTIFACT_DIR.mkdir(parents=True)
    art, shards_art = str(ARTIFACT_DIR / "scale"), str(ARTIFACT_DIR / "scale.shards")
    qs = queries[:n]
    out = {}
    t0 = time.perf_counter()
    index_io.save_index(index, art, impact_dtype="int8", docs_format="packed")
    out["save_s"] = time.perf_counter() - t0
    shards = shard_device_index(index, SHARDS)
    t0 = time.perf_counter()
    index_io.save_shards(shards, str(shards_art), impact_dtype="int8",
                         quantizer=index.quantizer, source_fingerprint=index.fingerprint())
    out["save_shards_s"] = time.perf_counter() - t0
    out["artifact_bytes"] = _dir_bytes(art)
    out["shards_bytes"] = _dir_bytes(shards_art)
    out["device_bytes"] = index.device_bytes("int8", "packed")["total"]
    for mmap in (False, True):
        t0 = time.perf_counter()
        loaded = index_io.load_index(art, mmap=mmap)
        out[f"load_s_mmap_{mmap}"] = time.perf_counter() - t0
        check(loaded.fingerprint() == index.fingerprint(), f"load mmap={mmap}: fingerprint")
    # The engine packs the docids again on the host (the load decoded them),
    # then copies the DeviceIndex up.
    t0 = time.perf_counter()
    loaded.packed_postings()
    out["pack_s"] = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mm_eng = Engine(loaded, k=10, device=dev, impact_dtype="int8", docs_format="packed")
    torch.cuda.synchronize()
    out["upload_s"] = time.perf_counter() - t0
    del loaded
    log(f"artifact: save_index int8/packed {out['save_s']:.2f} s, {out['artifact_bytes']} "
        f"B on disk against a {out['device_bytes']} B device index "
        f"(device_bytes_report); save_shards S={SHARDS} {out['save_shards_s']:.2f} s, "
        f"{out['shards_bytes']} B; load_index (fingerprint checked) "
        f"{out['load_s_mmap_False']:.2f} s eager, {out['load_s_mmap_True']:.2f} s mmap; "
        f"the engine's host re-pack of the docids {out['pack_s']:.2f} s, then the "
        f"DeviceIndex upload {out['upload_s']:.3f} s")

    # Cold start: from the from_artifact call to the first answered query.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng = Engine.from_artifact(art, k=10, device=dev)
    first = observe(eng, eng.plan(qs[0]))
    out["cold_start_s"] = time.perf_counter() - t0
    check((eng.impact_dtype, eng.docs_format) == ("int8", "packed"),
          f"from_artifact: {eng.impact_dtype}/{eng.docs_format}")
    check(first == observe(engine, engine.plan(qs[0])), "cold start: first answer differs")
    log(f"artifact: cold start (Engine.from_artifact to the first answered query) "
        f"{out['cold_start_s']:.2f} s")

    rng = np.random.default_rng(19)
    plans = [engine.plan(q) for q in qs]
    whole = [observe(engine, p) for p in plans]
    budgets = [int(rng.integers(1, max(w[2], 1) + 1)) for w in whole]
    for label, e in (("from_artifact", eng), ("mmap", mm_eng)):
        reset_launches()
        got = [observe(e, p) for p in plans]
        gotb = [observe(e, p, b) for p, b in zip(plans, budgets)]
        check_launches(read_launches(), {"traverse": 2 * len(plans)}, f"artifact {label}")
        for i, (p, b) in enumerate(zip(plans, budgets)):
            check(got[i] == whole[i], f"artifact {label} query {i}: {got[i]} != "
                  f"in-memory {whole[i]}")
            want = observe(engine, p, b)
            check(gotb[i] == want, f"artifact {label} query {i} budget {b}: {gotb[i]} "
                  f"!= in-memory {want}")
    caps = [int(rng.integers(0, w[4] + 1)) for w in whole]
    got_whole = [observe(eng, p) for p in plans]
    out["anytime"] = anytime_parity(eng, engine, plans, got_whole, caps, "artifact")
    del mm_eng

    bspec = BucketSpec(max_batch=BATCH)
    beng = BatchEngine.from_artifact(art, bspec, k=10, device=dev)
    ref_b = BatchEngine(engine, bspec)
    for label, bud in (("unbudgeted", None), ("budgeted", budgets)):
        before = beng.batches_run
        reset_launches()
        got = beng.run_batch(plans, budget_postings=bud)
        check_launches(read_launches(), {"traverse": beng.batches_run - before},
                       f"artifact batch {label}")
        want = ref_b.run_batch(plans, budget_postings=bud)
        for i, (g, w) in enumerate(zip(got, want)):
            check(batch_result_fields(g) == batch_result_fields(w),
                  f"artifact batch {label} query {i}: {batch_result_fields(g)} != "
                  f"{batch_result_fields(w)}")
    out["batch_chunks"] = beng.batches_run
    del beng

    seng = ShardedEngine.from_artifact(art, SHARDS, shards_path=shards_art, k=10,
                                       device=dev)
    sb = ShardedBatchEngine(seng, bspec)
    ref_s = ShardedBatchEngine(ShardedEngine(engine, SHARDS, shards=shards), bspec)
    for label, bud in (("unbudgeted", None), ("budgeted", budgets)):
        before = sb.batches_run
        reset_launches()
        got = sb.run_batch(plans, budget_postings=bud)
        check_launches(read_launches(), {"traverse": sb.batches_run - before},
                       f"artifact sharded {label}")
        want = ref_s.run_batch(plans, budget_postings=bud)
        for i, (g, w) in enumerate(zip(got, want)):
            check(sharded_fields(g) == sharded_fields(w),
                  f"artifact sharded {label} query {i}: {sharded_fields(g)} != "
                  f"{sharded_fields(w)}")
    out["sharded_chunks"] = sb.batches_run
    del seng, sb, ref_s

    # A shard set from another index, and one with no source fingerprint.
    other = build_index(make_corpus(n_docs=2000, n_terms=3000, n_topics=4, seed=9),
                        n_ranges=4, strategy="clustered")
    refused = []
    for name, fp in (("stale", other.fingerprint()), ("unverifiable", None)):
        path = str(ARTIFACT_DIR / name)
        index_io.save_shards(shard_device_index(other, 2), path, quantizer=other.quantizer,
                             source_fingerprint=fp)
        try:
            ShardedEngine.from_artifact(art, 2, shards_path=path, device=dev)
        except index_io.ArtifactError as e:
            refused.append(str(e))
        else:
            check(False, f"artifact: a {name} shard artifact was served")
    out["refused"] = refused

    # repack int32 -> packed keeps the fingerprint and the results.
    art32, packed = str(ARTIFACT_DIR / "scale32"), str(ARTIFACT_DIR / "scale32.packed")
    index_io.save_index(index, art32, impact_dtype="int8", docs_format="int32")
    t0 = time.perf_counter()
    index_io.repack(art32, packed)
    out["repack_s"] = time.perf_counter() - t0
    m = index_io.read_manifest(packed)
    check(m["docs_format"] == "packed" and m["fingerprint"] == index.fingerprint(),
          f"repack: {m['docs_format']} {m['fingerprint']}")
    shutil.rmtree(art32)
    rp = Engine.from_artifact(packed, k=10, device=dev)
    for i, p in enumerate(plans):
        check(observe(rp, p) == whole[i], f"repacked artifact query {i} differs")
    del rp
    log(f"artifact: {len(plans)} queries, unbudgeted and budgeted: Engine.from_artifact "
        f"and the mmap engine == in-memory on every observe_query field (one traverse "
        f"per query); anytime loop == in-memory, run out and Fixed-capped, range_step "
        f"launches {out['anytime']['launches']} = ranges {out['anytime']['ranges']}; "
        f"BatchEngine.from_artifact == BatchEngine ({out['batch_chunks']} chunks, one "
        f"traverse each); ShardedEngine.from_artifact(shards_path) == ShardedEngine on "
        f"every ShardedResult field ({out['sharded_chunks']} chunks, one traverse each); "
        f"stale and unverifiable shard artifacts refused; repack int32 -> packed "
        f"{out['repack_s']:.2f} s, fingerprint and results kept")
    shutil.rmtree(packed, ignore_errors=True)
    out["paths"] = dict(art=art, shards_art=shards_art)
    return out


# ----------------------------------------------------------- telemetry phase


TELEMETRY_MODES = ("host", "batch", "inflight", "sharded")


def count_syncs(fn):
    """``fn()`` and the synchronizing CUDA operations it ran, counted with
    ``torch.cuda.set_sync_debug_mode("warn")`` (a blocking copy either way
    counts, like ``synchronize()``), by the Python line that ran each."""
    import warnings
    from collections import Counter

    import torch

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            result = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    sites = Counter(f"{Path(w.filename).name}:{w.lineno}" for w in caught
                    if "synchroniz" in str(w.message))
    return result, sites


def serve_mode(mode: str, engine, queries, obs, cap):
    """One mode of serving ``queries`` on ``engine`` under ``obs``, with an
    infinite SLA (or a fixed postings ``cap``) so budgets never read the
    clock: (the results, exit reasons, dispatches). The host mode's
    results are ``TraverseResult``s, read after (``served_rows``)."""
    import numpy as np
    from repro_torch.core.range_daat import INT32_MAX, exit_reason
    from repro_torch.obs import NOOP
    from repro_torch.serving import (
        BatchEngine, BucketSpec, InflightServer, MicroBatchServer, ShardedBatchEngine,
        ShardedEngine, ShardedSlaBudgeter, SlaBudgeter, result_exit_reason)

    spec = BucketSpec(max_batch=BATCH)
    if mode == "host":
        engine.obs = obs
        try:
            res = [engine.traverse(engine.plan(q), INT32_MAX if cap is None else cap)
                   for q in queries]
        finally:
            engine.obs = NOOP
        return res, [exit_reason(r.exit_safe, r.exit_budget) for r in res], len(res)
    if mode == "sharded":
        beng = ShardedBatchEngine(ShardedEngine(engine, SHARDS, obs=obs), spec)
        bud = ShardedSlaBudgeter(sla_ms=float("inf"), n_shards=SHARDS, obs=obs)
    else:
        beng = BatchEngine(engine, spec, obs=obs)
        bud = SlaBudgeter(sla_ms=float("inf"), obs=obs)
    if cap is not None:
        shape = (SHARDS,) if mode == "sharded" else ()
        bud.budgets = lambda n, plans=None: np.full((n,) + shape, cap, np.int32)
    if mode == "inflight":
        srv = InflightServer(beng, bud, n_slots=BATCH, quantum=1, obs=obs)
        served = srv.replay(queries)
        dispatches = srv.steps_run
    else:
        srv = MicroBatchServer(beng, bud, max_batch=BATCH, obs=obs)
        served = srv.replay(queries, batch_size=BATCH)
        dispatches = beng.batches_run
    served = sorted(served, key=lambda s: s.rid)
    return served, [result_exit_reason(s.result) for s in served], dispatches


def served_rows(mode: str, engine, results) -> list:
    """``serve_mode``'s results as plain values: every field, query order."""
    if mode == "host":
        rows = []
        for r in results:
            ids, vals = engine.topk_docs(r.state)
            rows.append((ids.tolist(), vals.tolist(), int(r.state.postings),
                         int(r.state.blocks), r.ranges_processed, r.exit_safe,
                         r.exit_budget))
        return rows
    fields = sharded_fields if mode == "sharded" else batch_result_fields
    return [(s.rid, s.quanta, fields(s.result)) for s in results]


def telemetry_parity(index, queries, dev, n: int = 64) -> dict:
    """Each serving mode with an ``Instrumentation`` (trace sample 1.0,
    profiler on) and with ``NOOP``: every served field equal, the exit
    reasons of the counters equal to the results', no recompile, and the
    synchronizing operations per dispatch with ``obs`` off and on."""
    from collections import Counter

    from repro_torch.core.range_daat import Engine
    from repro_torch.obs import NOOP, Instrumentation

    engine = Engine(index, k=10, device=dev, impact_dtype="int8", docs_format="packed")
    qs = queries[:n]
    out = {}
    for mode in TELEMETRY_MODES:
        counter, labels = {"host": ("engine_queries", {}),
                           "batch": ("served_queries", {"server": "micro"}),
                           "inflight": ("served_queries", {"server": "inflight"}),
                           "sharded": ("served_queries", {"server": "micro"})}[mode]
        for cap in (None, 2000):
            obs = Instrumentation.make(sample_rate=1.0, profile=True)
            (off, _, disp_off), sites_off = count_syncs(
                lambda: serve_mode(mode, engine, qs, NOOP, cap))
            reset_launches()
            (on, reasons, disp_on), sites_on = count_syncs(
                lambda: serve_mode(mode, engine, qs, obs, cap))
            launches = read_launches()
            ctx = f"telemetry {mode} cap={cap}"
            check(served_rows(mode, engine, on) == served_rows(mode, engine, off),
                  f"{ctx}: instrumented serving differs from NOOP")
            check_launches(launches, {"traverse": disp_on}, ctx)
            got = Counter()
            metric = obs.metrics.counter(counter)
            for key in metric.labelsets():
                d = dict(key)
                if all(d.get(k) == w for k, w in labels.items()):
                    got[d["reason"]] += int(metric.value(**d))
            check(got == Counter(reasons), f"{ctx}: counted exits {dict(got)} != "
                  f"served {dict(Counter(reasons))}")
            recompiles = obs.profiler.recompiles()
            check(recompiles == 0, f"{ctx}: {recompiles} recompiles")
            prof = obs.profiler.snapshot()
            syncs_off, syncs_on = sum(sites_off.values()), sum(sites_on.values())
            extra = sites_on - sites_off
            out[f"{mode} cap={cap}"] = dict(
                queries=len(qs), dispatches=disp_on, exits=dict(got),
                syncs_off=syncs_off, syncs_on=syncs_on,
                syncs_per_dispatch_off=syncs_off / disp_off,
                syncs_per_dispatch_on=syncs_on / disp_on,
                sync_sites_off=dict(sites_off), extra_sync_sites_on=dict(extra),
                recompiles=recompiles, profiler=prof)
            log(f"{ctx}: {len(qs)} queries, obs on == NOOP on every served field; "
                f"exits {dict(got)} counted == served; recompiles 0 "
                f"({sum(s['compiles'] for s in prof.values())} compiles); syncs per "
                f"dispatch off {syncs_off / disp_off:.2f}, on {syncs_on / disp_on:.2f} "
                f"({disp_on} dispatches); obs off sites {dict(sites_off)}; "
                + ("no extra sync with obs on" if not extra else
                   f"extra with obs on: {dict(extra)}"))
    return out


def obs_windows(engine, queries, rounds: int = 3) -> dict:
    """The batch and in-flight serving windows with ``obs`` off and on in
    turns (off, on, on, off, ...; ``2 * rounds`` windows a mode; on: trace
    sample 1.0, profiler on): q/s, P99, the host time ``obs`` adds per query
    (median 1/q/s on minus off), and the profiler's split per dispatch of
    the last enabled window (its ``plan`` is the batch's host staging, the
    in-flight's planning overlapped with the kernel; ``device`` the
    launch's CUDA events)."""
    import numpy as np
    from repro_torch.launch import serve
    from repro_torch.obs import NOOP, Instrumentation

    out = {}
    for mode in ("batch", "inflight"):
        runs = {"off": [], "on": []}
        for r in range(2 * rounds):
            enabled = (r % 4) in (1, 2)
            obs = Instrumentation.make(sample_rate=1.0, profile=True) if enabled else NOOP
            reset_launches()
            if mode == "batch":
                st = serve.serve_batch(engine, queries, BATCH, obs=obs)
                want = {"traverse": st["batches"], "range_step": st["ranges"]}
            else:
                st = serve.serve_inflight(engine, queries, BATCH, 1, obs=obs)
                want = {"traverse": st["steps"], "range_step": st["ranges"]}
            check_launches(read_launches(), want, f"{mode} window, obs {enabled}")
            runs["on" if enabled else "off"].append(st)
            if enabled:
                site = "batch_engine" if mode == "batch" else "inflight"
                snap = obs.profiler.snapshot()[site]
                check(snap["recompiles"] == 0, f"obs-on {mode} window: recompiles")
                served = obs.metrics.counter("served_queries").total()
                check(served == len(queries),
                      f"obs-on {mode} window: {served} served counted")
                last = dict(snap=snap, traces=obs.tracer.finished,
                            slo_state={k: v["state"] for k, v in st["slo"].items()})
        snap = last["snap"]
        med = {k: float(np.median([1e3 / s["qps"] for s in v])) for k, v in runs.items()}
        out[mode] = dict(
            qps={k: [s["qps"] for s in v] for k, v in runs.items()},
            p99_ms={k: [s["p99_ms"] for s in v] for k, v in runs.items()},
            miss_pct={k: [s["miss_pct"] for s in v] for k, v in runs.items()},
            ms_per_query=med, added_ms_per_query=med["on"] - med["off"],
            dispatches=snap["dispatches"], compiles=snap["compiles"],
            split={k: snap[k] / snap["dispatches"]
                   for k in ("plan_ms", "dispatch_ms", "device_ms", "transfer_ms")},
            traces=last["traces"], slo_state=last["slo_state"])
    return out


# ---------------------------------------------------------- control plane


CONTROL_QUERIES = 64  # the control phases' parity queries
CONTROL_REPLICAS = 2  # one card: the replica groups serve through the sharded engine
# Partitioned IR (serve/distributed_ir.py): the preset corpus split round-robin.
IR_SHARDS = 4
IR_RANGES = 8  # ranges per sub-index (build_sharded_index's default)
# A lane's postings budget that binds: a preset query scores a few hundred
# postings a shard, so 2,000 cut no lane short on the H100.
IR_BUDGET = 100
# Anytime MIPS (serve/retrieval.py): the reference's recsys candidate count
# (_REC_CANDIDATES, src/repro/configs/base.py:498) at MIND's width (D 64,
# src/repro/configs/other_archs.py:25-30), 64 k-means ranges.
MIPS = dict(n=1_000_000, dim=64, clusters=64, centers=256)
MIPS_TOL = 1e-5  # rtol and atol on scores, card against the CPU


def plane_dispatches(*bengines) -> int:
    """Dispatches (``traverse`` launches on the card) of distinct batch engines."""
    return sum(b.batches_run for b in {id(b): b for b in bengines}.values())


def control_parity(index, queries, engine, dev, n: int = CONTROL_QUERIES) -> tuple:
    """(a) and (b) of the control phase at the scale cell: the record and
    the plane, which (c) and (d) go on with.

    ``ControlPlane(engine, 4, n_replicas=2)`` on one card (``replica_mesh``
    False, no replica-mesh dispatch) serves ``n`` unbudgeted queries equal to
    ``ShardedBatchEngine(ShardedEngine(engine, 4))`` and to the same plane
    over the plain path on the card, on every ``ShardedResult`` field; then
    shard 1 down (equal to the plain plane, every query whose terms reach
    shard 1 inexact), then up (equal to the healthy run again). One
    ``traverse`` launch per dispatch, nothing else.
    """
    from repro_torch.control import ControlPlane
    from repro_torch.core.range_daat import Engine
    from repro_torch.serving import BucketSpec, ShardedBatchEngine, ShardedEngine

    qs = queries[:n]
    spec = BucketSpec(max_batch=BATCH)
    t0 = time.perf_counter()
    plane = ControlPlane(engine, n_shards=SHARDS, n_replicas=CONTROL_REPLICAS, spec=spec)
    build_s = time.perf_counter() - t0
    st = plane.stats()
    check(st["replica_mesh"] is False and plane.replicas.group_mesh is None,
          f"control: replica mesh on one card: {st['replica_mesh']}")
    base = ShardedBatchEngine(ShardedEngine(engine, SHARDS, shards=plane.sengine.shards), spec)
    plain_eng = Engine(index, k=10, device=dev, impl="torch", impact_dtype="int8",
                       docs_format="packed")
    plain = ControlPlane(plain_eng, n_shards=SHARDS, n_replicas=CONTROL_REPLICAS, spec=spec)
    check(plain.cuts.tolist() == plane.cuts.tolist(), "control: plain plane's cuts differ")
    out = dict(build_s=build_s, cuts=plane.cuts.tolist(), replica_mesh=st["replica_mesh"])

    def serve(p, label):
        before = plane_dispatches(plane.bengine, plane.bengine_single)
        reset_launches()
        t0 = time.perf_counter()
        served = sorted(p.replay(qs, batch_size=BATCH), key=lambda s: s.rid)
        secs = time.perf_counter() - t0
        launches = read_launches()
        if p is plane:
            check_launches(launches, {"traverse": plane_dispatches(
                plane.bengine, plane.bengine_single) - before}, f"control {label}")
        else:
            check(not any(launches.values()), f"control {label}: launches {launches}")
        return [s.result for s in served], launches, secs

    healthy, launches, secs = serve(plane, "healthy")
    want = base.run_batch([engine.plan(q) for q in qs])
    plain_healthy, _, plain_s = serve(plain, "healthy, plain")
    for i, (g, w, p) in enumerate(zip(healthy, want, plain_healthy)):
        check(sharded_fields(g) == sharded_fields(w),
              f"control (a) query {i}: plane {sharded_fields(g)} != ShardedBatchEngine "
              f"{sharded_fields(w)}")
        check(sharded_fields(g) == sharded_fields(p),
              f"control (a) query {i}: plane on cuda != plane on the plain path")
    out["healthy"] = dict(launches=launches["traverse"], kernel_s=secs, plain_s=plain_s,
                          exact=sum(r.exact for r in healthy))
    for p in (plane, plain):
        p.mark_down(1)
    degraded, launches, secs = serve(plane, "shard 1 down")
    plain_degraded, _, _ = serve(plain, "shard 1 down, plain")
    reach = 0
    for i, (g, p, q) in enumerate(zip(degraded, plain_degraded, qs)):
        check(sharded_fields(g) == sharded_fields(p),
              f"control (b) query {i}: plane on cuda {sharded_fields(g)} != plain "
              f"{sharded_fields(p)}")
        check(g.shard_exit_reasons[1] == "down" and g.shard_postings[1] == 0,
              f"control (b) query {i}: shard 1 served while down")
        if plane.sengine.query_shard_mass(engine.plan(q))[1] > 0:
            reach += 1
            check(not g.exact and g.fidelity_bound > 0,
                  f"control (b) query {i}: exact with shard 1 down")
    out["degraded"] = dict(launches=launches["traverse"], kernel_s=secs, reaching=reach,
                           inexact=sum(not r.exact for r in degraded),
                           max_fidelity_bound=max(r.fidelity_bound for r in degraded))
    for p in (plane, plain):
        p.mark_up(1)
    recovered, launches, _ = serve(plane, "recovered")
    for i, (g, w) in enumerate(zip(recovered, healthy)):
        check(sharded_fields(g) == sharded_fields(w),
              f"control (b) query {i}: after mark_up {sharded_fields(g)} != healthy")
    out["recovered_launches"] = launches["traverse"]
    log(f"control (a): ControlPlane(S={SHARDS}, replicas={CONTROL_REPLICAS}) on one card "
        f"(built in {build_s:.2f} s, cuts {out['cuts']}, replica_mesh False, 0 replica-mesh "
        f"dispatches): {n} unbudgeted queries == ShardedBatchEngine(ShardedEngine(engine, "
        f"{SHARDS})) == the plane on the plain path, every ShardedResult field; "
        f"{out['healthy']['launches']} traverse launches, others 0; cuda "
        f"{secs:.3f} s, plain {plain_s:.2f} s")
    log(f"control (b): shard 1 down: {n} queries == plain on every field (fidelity_bound "
        f"and exact included), {out['degraded']['inexact']} inexact, {reach} of them "
        f"reach shard 1 (each inexact), largest fidelity_bound "
        f"{out['degraded']['max_fidelity_bound']}; mark_up: == (a) again")
    return out, plane


def reshard_phase(plane, index, queries, engine, dev, n: int = CONTROL_QUERIES) -> dict:
    """(c): a live reshard to the planner's proposal (or the first boundary
    moved one range) with ``drain_once`` at BATCH queued queries a drain,
    each stage's wall, the longest drain, queries served mid-cutover and the
    arm-to-cutover wall; the same layout stop-the-world (carve, build, warm
    with the queue blocked) before it; after the cutover ``n`` queries equal
    a fresh ``ShardedEngine`` over ``shard_device_index(index, cuts=...)``."""
    import numpy as np
    from repro_torch.control import ReplicaGroupEngine, ReshardTask
    from repro_torch.core.clustered_index import shard_device_index
    from repro_torch.serving import ShardedBatchEngine, ShardedEngine

    if plane.planner.should_reshard():
        cuts, source = plane.planner.propose(), "planner"
    else:
        cuts = plane.cuts.copy()
        cuts[1] = cuts[1] - 1 if cuts[1] > 1 else cuts[1] + 1
        source = "nudge"
    widths = sorted({w for (_, w) in plane.bengine.compiled_shapes})

    def timed(task):
        stages, step = [], task.step

        def run():
            t0 = time.perf_counter()
            stage = step()
            stages.append((stage, (time.perf_counter() - t0) * 1e3))
            return stage

        task.step = run
        return stages

    # Stop-the-world first: the queue waits behind carve + build + warm.
    def build(shards):
        seng = ShardedEngine(engine, len(shards), shards=shards)
        return seng, ShardedBatchEngine(ReplicaGroupEngine(seng, CONTROL_REPLICAS),
                                        plane.spec)

    for q in queries[:BATCH]:
        plane.submit(q)
    t0 = time.perf_counter()
    stw = ReshardTask(plane.sengine.shards, cuts, build, widths)
    stw_stages = timed(stw)
    while not stw.ready:
        stw.step()
    stw_ms = (time.perf_counter() - t0) * 1e3
    blocked = plane.drain_once()
    stw_p99 = float(np.percentile([s.latency_ms for s in blocked], 99))

    reset_launches()
    t_arm = time.perf_counter()
    task = plane.start_reshard(cuts)
    stages = timed(task)
    drains, qi, served = [], 0, 0
    engines = [plane.bengine, plane.bengine_single]
    before = plane_dispatches(*engines)
    while plane.reshard_task is not None:
        for q in queries[qi % len(queries):qi % len(queries) + BATCH]:
            plane.submit(q)
        qi += BATCH
        t0 = time.perf_counter()
        got = plane.drain_once()
        drains.append((time.perf_counter() - t0) * 1e3)
        served += len(got)
        check(len(got) > 0, "reshard: a drain served nothing mid-cutover")
    reshard_ms = (time.perf_counter() - t_arm) * 1e3
    launches = read_launches()
    engines.append(task.bengine)  # the successor, warmed inside the task
    check_launches(launches, {"traverse": plane_dispatches(*engines) - before},
                   "live reshard")
    check(plane.cuts.tolist() == [int(c) for c in cuts], "reshard: cuts not adopted")
    fresh = ShardedEngine(engine, SHARDS, shards=shard_device_index(index, cuts=cuts))
    plans = [engine.plan(q) for q in queries[:n]]
    got = plane.bengine.run_batch(plans)
    want = ShardedBatchEngine(fresh, plane.spec).run_batch(plans)
    for i, (g, w) in enumerate(zip(got, want)):
        check(sharded_fields(g) == sharded_fields(w),
              f"reshard query {i}: plane after cutover != fresh ShardedEngine at the cuts")

    def by_stage(st):
        return {name: [round(ms, 3) for s, ms in st if s == name]
                for name in ("carve", "build", "warm")}

    out = dict(source=source, cuts=[int(c) for c in cuts], widths=widths,
               live=dict(stages_ms=by_stage(stages), steps=task.steps_done,
                         drains_ms=drains, longest_drain_ms=max(drains),
                         median_drain_ms=float(np.median(drains)),
                         served_mid_cutover=plane.queries_served_during_reshard,
                         reshard_ms=reshard_ms, launches=launches["traverse"]),
               stop_the_world=dict(stages_ms=by_stage(stw_stages), total_ms=stw_ms,
                                   blocked_queries=len(blocked), blocked_p99_ms=stw_p99))
    live = out["live"]
    log(f"control (c): live reshard ({source}) {plane.cuts.tolist()}: carve per shard "
        f"{live['stages_ms']['carve']} ms, build {live['stages_ms']['build']} ms, warm per "
        f"width {live['stages_ms']['warm']} ms; {len(drains)} drains of {BATCH} queued "
        f"queries, longest {live['longest_drain_ms']:.1f} ms (median "
        f"{live['median_drain_ms']:.2f} ms), {live['served_mid_cutover']} queries served "
        f"mid-cutover, arm to cutover {reshard_ms:.1f} ms, traverse launches "
        f"{live['launches']}, others 0; after the cutover {n} queries == a fresh "
        f"ShardedEngine at the cuts")
    log(f"control (c): the same layout stop-the-world: carve "
        f"{out['stop_the_world']['stages_ms']['carve']} ms, build "
        f"{out['stop_the_world']['stages_ms']['build']} ms, warm "
        f"{out['stop_the_world']['stages_ms']['warm']} ms = {stw_ms:.1f} ms with the "
        f"queue blocked ({len(blocked)} queued queries, P99 {stw_p99:.1f} ms)")
    return out


def control_window(plane, engine, queries, sla_ms: float, rounds: int = 3) -> dict:
    """(d): the plane's serving window against the sharded window over the
    same sharded engine (S = 4, batch 16) in turns (sharded, control,
    control, sharded, ...; ``2 * rounds`` windows each), both budgeted by a
    fresh ``ShardedSlaBudgeter`` of one configuration (the plane's BoundSum
    mode, SLA ``sla_ms``: the sharded serving window's); q/s, P99 and the
    miss share against ``sla_ms``; what the plane adds per batch is the
    difference of the median wall per batch. One ``traverse`` per dispatch."""
    import numpy as np
    from repro_torch.core.anytime import Reactive
    from repro_torch.serving import MicroBatchServer, ShardedBatchEngine, ShardedSlaBudgeter

    beng = ShardedBatchEngine(plane.sengine, plane.spec)
    widths = sorted({plane.spec.width_bucket(engine.plan(q).blk_tab_host.shape[1])
                     for q in queries})
    beng.warmup(widths)
    plane.bengine.warmup(widths)

    def budgeter():
        return ShardedSlaBudgeter(sla_ms=sla_ms, n_shards=plane.n_shards, mode="boundsum",
                                  shard_mass=plane.sengine.query_shard_mass,
                                  policy=Reactive(alpha=1.0, beta=1.5, q=0.01))

    runs = {"sharded": [], "control": []}
    for r in range(2 * rounds):
        mode = "control" if (r % 4) in (1, 2) else "sharded"
        bud = budgeter()
        if mode == "control":
            bud.down_mask = plane.health.shard_down_mask
            plane.budgeter = plane.server.budgeter = bud
            before = plane_dispatches(plane.bengine, plane.bengine_single)
            run, count = (lambda: plane.replay(queries, batch_size=BATCH),
                          lambda: plane_dispatches(plane.bengine, plane.bengine_single))
        else:
            server = MicroBatchServer(beng, bud, max_batch=BATCH)
            before = beng.batches_run
            run, count = (lambda: server.replay(queries, batch_size=BATCH),
                          lambda: beng.batches_run)
        reset_launches()
        t0 = time.perf_counter()
        served = run()
        wall = time.perf_counter() - t0
        check_launches(read_launches(), {"traverse": count() - before},
                       f"{mode} window {r}")
        lat = np.asarray([s.latency_ms for s in served])
        batches = -(-len(queries) // BATCH)
        runs[mode].append(dict(qps=len(served) / wall, p99_ms=float(np.percentile(lat, 99)),
                               miss_pct=float((lat > sla_ms).mean() * 100),
                               ms_per_batch=wall * 1e3 / batches,
                               dispatches=count() - before))
    med = {m: float(np.median([w["ms_per_batch"] for w in v])) for m, v in runs.items()}
    out = dict(sla_ms=sla_ms, rounds=rounds, **{m: v for m, v in runs.items()},
               median_ms_per_batch=med,
               plane_adds_ms_per_batch=med["control"] - med["sharded"])
    for m in ("sharded", "control"):
        log(f"control (d): {m} window in turns, {len(queries)} queries at batch {BATCH}, "
            f"SLA {sla_ms:.3f} ms: q/s {[round(w['qps'], 1) for w in runs[m]]}, P99 ms "
            f"{[round(w['p99_ms'], 3) for w in runs[m]]}, miss % "
            f"{[round(w['miss_pct'], 2) for w in runs[m]]}")
    log(f"control (d): the plane adds {out['plane_adds_ms_per_batch']:.4f} ms a batch "
        f"(median {med['control']:.4f} against {med['sharded']:.4f} ms)")
    return out


def journal_phase(paths: dict, queries, dev, n: int = CONTROL_QUERIES) -> dict:
    """(e): over the chain phase's base artifact and its delta head, a plane
    journals a reshard (first boundary moved one range) and ``mark_down(1)``;
    ``ControlPlane.from_artifact(path, 4, replay=True)`` in a fresh plane
    then has the same cuts and ledger and answers ``n`` queries equal on
    every ``ShardedResult`` field (one ``traverse`` per dispatch)."""
    from repro_torch.control import ControlPlane
    from repro_torch.serving import BucketSpec

    out = {}
    kw = dict(spec=BucketSpec(max_batch=BATCH), engine_kwargs=dict(k=10, device=dev))
    for name in ("base", "head"):
        path = paths[name]
        t0 = time.perf_counter()
        plane = ControlPlane.from_artifact(path, SHARDS, **kw)
        open_s = time.perf_counter() - t0
        cuts = plane.cuts.copy()
        cuts[1] = cuts[1] - 1 if cuts[1] > 1 else cuts[1] + 1
        plane.start_reshard(cuts)
        while plane.reshard_task is not None:
            plane.submit(queries[0])
            plane.drain_once()
        plane.mark_down(1)
        reset_launches()
        before = plane_dispatches(plane.bengine, plane.bengine_single)
        want = sorted(plane.replay(queries[:n], batch_size=BATCH), key=lambda s: s.rid)
        t0 = time.perf_counter()
        fresh = ControlPlane.from_artifact(path, SHARDS, replay=True, **kw)
        replay_s = time.perf_counter() - t0
        check(fresh.cuts.tolist() == plane.cuts.tolist() == [int(c) for c in cuts],
              f"journal {name}: replayed cuts {fresh.cuts.tolist()}")
        check(fresh.health._up.tolist() == plane.health._up.tolist(),
              f"journal {name}: replayed ledger differs")
        got = sorted(fresh.replay(queries[:n], batch_size=BATCH), key=lambda s: s.rid)
        launches = read_launches()
        check_launches(launches, {"traverse": plane_dispatches(
            plane.bengine, plane.bengine_single) - before + plane_dispatches(
            fresh.bengine, fresh.bengine_single)}, f"journal {name}")
        for i, (g, w) in enumerate(zip(got, want)):
            check(sharded_fields(g.result) == sharded_fields(w.result),
                  f"journal {name} query {i}: replayed plane != journaling plane")
        records = plane.journal.records()
        out[name] = dict(open_s=open_s, replay_s=replay_s, cuts=plane.cuts.tolist(),
                         records=[r["kind"] for r in records],
                         fingerprint=records[0]["fingerprint"],
                         launches=launches["traverse"])
        log(f"control (e): {name} artifact: journaled {out[name]['records']} (fingerprint "
            f"{out[name]['fingerprint']}); from_artifact(replay=True) in {replay_s:.2f} s: "
            f"cuts {fresh.cuts.tolist()}, ledger and {n} answers equal (shard 1 down); "
            f"traverse launches {launches['traverse']}")
    return out


# ------------------------------------------------- partitioned IR and MIPS


def build_ir(src: str, cfg: dict, n_queries: int) -> dict:
    """Worker: ``build_sharded_index`` over the preset corpus (M = IR_SHARDS,
    IR_RANGES ranges a sub-index, ``cfg``'s strategy) on the CPU, as numpy:
    the stacked arrays, each sub-index's arrays, and a query log."""
    sys.path.insert(0, src)
    from repro_torch.core.clustered_index import INDEX_ARRAYS
    from repro_torch.data.synth import make_corpus, make_query_log
    from repro_torch.serve.distributed_ir import build_sharded_index

    t0 = time.perf_counter()
    corpus = make_corpus(n_docs=cfg["n_docs"], n_terms=cfg["n_terms"],
                         n_topics=cfg["n_topics"], mean_doc_len=cfg["mean_doc_len"], seed=0)
    arrays, engines = build_sharded_index(corpus, IR_SHARDS, IR_RANGES,
                                          strategy=cfg["strategy"], device="cpu")
    build_s = time.perf_counter() - t0
    subs = []
    for e in engines:
        idx = e.index
        a = {n: getattr(idx, n) for n in INDEX_ARRAYS if n not in ("doc_order", "range_ends")}
        a["doc_order"] = idx.arrangement.doc_order
        a["range_ends"] = idx.arrangement.range_ends
        subs.append(dict(arrays=a, fingerprint=idx.fingerprint(), meta=dict(
            n_docs=idx.n_docs, n_terms=idx.n_terms, strategy=idx.arrangement.strategy,
            quant_bits=idx.quantizer.bits, quant_scale=idx.quantizer.scale)))
    fields = ("docs", "impacts", "blk_start", "blk_len", "blk_maximp", "range_starts",
              "doc_base")
    return dict(stacked={f: getattr(arrays, f).numpy() for f in fields},
                s_pad=arrays.s_pad, k=arrays.k, subs=subs, build_s=build_s,
                terms=make_query_log(corpus, n_queries=n_queries, seed=QUERY_SEED).terms)


def ir_phase(job, dev, n: int = CONTROL_QUERIES) -> dict:
    """Partitioned IR on the card: ``sharded_anytime_query`` over the Q x M
    (query, shard) lanes, one ``traverse`` launch a call, equal on every
    output (values, global ids, ranges) to its plain path on the card
    (``impl="torch"``), unbudgeted and at a postings budget, and on the
    score lists to the merged per-shard exhaustive oracles."""
    import numpy as np
    import torch
    from repro_torch.core.clustered_index import index_from_arrays
    from repro_torch.core.oracle import exhaustive_topk
    from repro_torch.core.range_daat import Engine
    from repro_torch.serve.distributed_ir import (
        ShardedIndexArrays, plan_queries, sharded_anytime_query)

    out = job.get()
    engines = []
    for sub in out["subs"]:
        idx = index_from_arrays(sub["arrays"], **sub["meta"])
        check(idx.fingerprint() == sub["fingerprint"], "ir: fingerprint changed in transfer")
        engines.append(Engine(idx, k=10, device=dev))
    arrays = ShardedIndexArrays(
        **{f: torch.from_numpy(a) for f, a in out["stacked"].items()},
        s_pad=out["s_pad"], k=out["k"]).to(dev)
    terms = out["terms"][:n]
    t0 = time.perf_counter()
    tables = plan_queries(engines, terms)
    plan_s = time.perf_counter() - t0
    res = dict(build_s=out["build_s"], plan_s=plan_s, shards=IR_SHARDS, ranges=IR_RANGES,
               s_pad=arrays.s_pad, nnz=int(arrays.docs.shape[1]))
    # The mesh phase's 2 x 4 context runs on these arrays and tables.
    _pickle(MESH_DIR / "ir_in.pkl", dict(stacked=out["stacked"], s_pad=out["s_pad"],
                                         k=out["k"], tables=[np.asarray(t) for t in tables]))
    for label, budget in (("unbudgeted", 2**31 - 1), ("budgeted", IR_BUDGET)):
        reset_launches()
        got = [t.cpu() for t in sharded_anytime_query(arrays, tables, None, budget,
                                                       impl="cuda")]
        launches = read_launches()
        check_launches(launches, {"traverse": 1}, f"ir {label}")
        want = [t.cpu() for t in sharded_anytime_query(arrays, tables, None, budget,
                                                        impl="torch")]
        for name, g, w in zip(("vals", "ids", "ranges"), got, want):
            check(g.dtype == w.dtype and g.tolist() == w.tolist(),
                  f"ir {label}: {name} on cuda != the plain path")
        ms = time_ms(lambda: sharded_anytime_query(arrays, tables, None, budget,
                                                   impl="cuda"), iters=20, warmup=3)
        res[label] = dict(launches=launches["traverse"], ms_per_call=ms,
                          ranges=int(got[2]), lanes=len(terms) * IR_SHARDS)
    check(res["budgeted"]["ranges"] < res["unbudgeted"]["ranges"],
          f"ir: a {IR_BUDGET}-posting budget cut no lane short")
    vals = [t.cpu() for t in sharded_anytime_query(arrays, tables, None)][0]
    for qi in range(len(terms)):
        merged = []
        for e in engines:
            merged.extend(exhaustive_topk(e.index, terms[qi], 10)[1].tolist())
        expect = [v for v in sorted(merged, reverse=True)[:10] if v > 0]
        check(sorted([v for v in vals[qi].tolist() if v > 0], reverse=True) == expect,
              f"ir query {qi}: merged top-k scores != the merged per-shard oracles")
    log(f"partitioned IR: build_sharded_index (preset corpus, M = {IR_SHARDS}, "
        f"{IR_RANGES} ranges a shard, worker) {out['build_s']:.1f} s; {len(terms)} queries "
        f"x {IR_SHARDS} shards: cuda == plain on vals, ids and ranges, unbudgeted and at "
        f"{IR_BUDGET} postings a lane; == the merged per-shard oracles; one traverse a "
        f"call, {res['unbudgeted']['ms_per_call']:.3f} ms a call unbudgeted "
        f"({res['unbudgeted']['ranges']} lane-ranges), "
        f"{res['budgeted']['ms_per_call']:.3f} ms budgeted "
        f"({res['budgeted']['ranges']} lane-ranges)")
    res["arch"] = arch_ir(arrays, tables)
    res["arch_dry"] = res["arch"].pop("dry")  # the dry run's (i) reads it
    return res


# ---------------------------------------------------------------- mesh phase

MESH_DIR = ROOT / ".cache" / "chip_smoke_mesh"  # git-ignored; removed after
MESH_TIMEOUT_S = 600  # a spawned group's limit, load and build included
MESH_IR = (2, 4)  # the partitioned IR's (data, model) context: 8 ranks
MESH_PLANE = (2, 2)  # the control plane's (replicas, shards) mesh on the preset
MESH_STARVED = 128  # one block: the starved shard's postings budget


def _pickle(path, obj) -> None:
    import pickle

    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(obj, f)


def _unpickle(path):
    import pickle

    with open(path, "rb") as f:
        return pickle.load(f)


def _count_plain_traverse():
    """On the CPU (a rehearsal) count the plain traversal's outermost calls
    as ``kernel.traverse`` launches, as the CPU rehearsals of the other
    phases do."""
    from repro_torch.kernels.range_scorer import kernel, ref

    real = ref.traverse_ref

    def counted(*a, **kw):
        kernel.traverse.launches += 1
        return real(*a, **kw)

    ref.traverse_ref = counted


def mesh_rank(case: str, rank: int, world: int, src: str, device: str | None) -> None:
    """A spawned rank of the mesh phase: its process group (``file://``
    under ``MESH_DIR``), the kernel library from the parent's build, then
    ``case``; rank 0 writes what every rank saw to ``MESH_DIR/<case>.out``."""
    sys.path.insert(0, src)
    import torch.distributed as dist
    from repro_torch.distributed import sharding as ms
    from repro_torch.kernels.range_scorer import kernel

    t0 = time.perf_counter()
    rt = ms.init_mesh_group(device=device,
                            init_method=f"file://{MESH_DIR / (case + '.init')}",
                            rank=rank, world_size=world, timeout_s=MESH_TIMEOUT_S - 60)
    if rt.device.type == "cuda" and case in ("serve", "ir", "nccl"):
        _, build_s, _ = kernel.build()  # the parent's library: a cache hit
    elif rt.device.type == "cuda":
        build_s = 0.0  # the model paths run no kernel
    else:
        build_s = 0.0
        _count_plain_traverse()
    job = _unpickle(MESH_DIR / f"{case}.in")
    out = {"case": case, "backend": rt.backend, "staged": rt.staged,
           "start_s": time.perf_counter() - t0}
    sections = MESH_CASES[case](rt, job, out)
    ranks = [None] * rt.world
    dist.all_gather_object(ranks, dict(rank=rt.rank, device=str(rt.device),
                                       build_s=build_s, launches=sections),
                           group=rt.control)
    if rt.rank == 0:
        out["ranks"] = ranks
        _pickle(MESH_DIR / f"{case}.out", out)
    ms.close_mesh_group()


def _section(rt, fn):
    """Rank 0 drives ``fn()`` (its answers) while the other ranks execute;
    then this rank's ``traverse`` launches in the section."""
    from repro_torch.distributed import sharding as ms
    from repro_torch.kernels.range_scorer import kernel

    kernel.traverse.launches = 0
    res = None
    if rt.rank == 0:
        with ms.driving():
            res = fn()
    else:
        ms.worker_loop()
    return res, kernel.traverse.launches


def _gloo_probe(rt, iters: int = 50) -> dict:
    """Whether this build's gloo takes card tensors in ``all_gather``, and
    the time of one gather of a dispatch's rows ([16, 2k+5] int32) staged
    through the host (the port's way) and, where gloo takes them, direct."""
    import torch
    import torch.distributed as dist

    x = torch.full((BATCH, 25), rt.rank, dtype=torch.int32, device=rt.device)

    def gather(t):
        parts = [torch.empty_like(t) for _ in range(rt.world)]
        dist.all_gather(parts, t)
        return parts

    out = {}
    for label, fn in (("staged", lambda: [p.to(rt.device) for p in gather(x.cpu())]),
                      ("direct", lambda: gather(x))):
        try:
            parts = fn()
            ok = [int(p[0, 0]) for p in parts] == list(range(rt.world))
        except Exception as e:  # noqa: BLE001 - the finding is the error itself
            out[label] = dict(ok=False, error=f"{type(e).__name__}: {str(e)[:300]}")
            continue
        if rt.device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        if rt.device.type == "cuda":
            torch.cuda.synchronize()
        out[label] = dict(ok=ok, ms=(time.perf_counter() - t0) * 1e3 / iters)
    return out


def _timed_mesh_steps(split: list):
    """Time each ``ShardedEngine`` mesh step on this rank as (upload +
    ``traverse`` ms, gather + merge ms): the host clock, with a device
    synchronisation at the start, after the kernel and at the end.
    Returns the function that undoes the wrapping."""
    import torch
    from repro_torch.serving import sharded

    real_lanes, real_step = sharded.traverse_lanes, sharded.ShardedEngine._mesh_step
    marks = []

    def sync():
        if torch.cuda.is_available():
            torch.cuda.synchronize()

    def lanes(*a, **kw):
        out = real_lanes(*a, **kw)
        sync()
        marks.append(time.perf_counter())
        return out

    def step(self, *a, **kw):
        sync()
        t0 = time.perf_counter()
        out = real_step(self, *a, **kw)
        sync()
        t1 = marks.pop()
        split.append(((t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3))
        return out

    sharded.traverse_lanes, sharded.ShardedEngine._mesh_step = lanes, step

    def undo():
        sharded.traverse_lanes, sharded.ShardedEngine._mesh_step = real_lanes, real_step

    return undo


def mesh_case_serve(rt, job, out) -> list:
    """Four ranks: the scale cell's four shards, each rank loading its own
    from the shard artifact, then the 2 x 2 replica plane on the preset."""
    from repro_torch.control import ControlPlane
    from repro_torch.core.range_daat import Engine
    from repro_torch.distributed import sharding as ms
    from repro_torch.serving import BucketSpec, ShardedBatchEngine, ShardedEngine

    launches = []
    out["gloo_cuda"] = _gloo_probe(rt)
    t0 = time.perf_counter()
    seng = ShardedEngine.from_artifact(job["art"], SHARDS, shards_path=job["shards_art"],
                                       use_mesh=True, k=10, device=rt.device)
    out["load_s"] = time.perf_counter() - t0
    out["local_rows"] = int(seng.dix.impacts.shape[0])
    split = []
    pe = Engine.from_artifact(job["preset_art"], k=10, device=rt.device)
    ms.register(pe)  # rank 0 builds the plane's engines on it while it drives

    def sharded():
        plans = [seng.plan(q) for q in job["queries"]]
        sb = ShardedBatchEngine(seng, BucketSpec(max_batch=BATCH))
        res = {}
        for label, kw in (("unbudgeted", {}),
                          ("budgeted", dict(budget_postings=job["budgets"])),
                          ("starved", dict(budget_postings=job["starved"]))):
            before, n_split = sb.batches_run, len(split)
            t0 = time.perf_counter()
            got = sb.run_batch(plans, **kw)
            res[label] = dict(fields=[sharded_fields(r) for r in got],
                              dispatches=sb.batches_run - before,
                              wall_ms=(time.perf_counter() - t0) * 1e3,
                              split=split[n_split:])
        return res

    undo = _timed_mesh_steps(split)
    out["sharded"], n = _section(rt, sharded)
    undo()
    launches.append(n)

    def plane():
        import numpy as np

        qs = job["preset_queries"]
        p = ControlPlane(pe, n_shards=MESH_PLANE[1], n_replicas=MESH_PLANE[0],
                         spec=BucketSpec(max_batch=BATCH), use_mesh=True)
        check(p.stats()["replica_mesh"], "mesh plane: replica_mesh is False")
        res = dict(dispatches=0)
        res["healthy"] = _served_fields(p.replay(qs, batch_size=BATCH))
        # A batch of 3 on 2 replica rows: one pad lane.
        se, rep = p.sengine, p.replicas
        plans = [se.plan(q) for q in qs[:3]]
        w = max(se.shard_plan(pl)[0].shape[-1] for pl in plans)
        tabs = [np.stack(t) for t in zip(*[se.shard_plan(pl, w) for pl in plans])]
        caps = np.full((3, MESH_PLANE[1]), 2**31 - 1)
        res["odd"] = rep.dispatch(*tabs, caps, caps).cpu().numpy().tolist()
        res["odd_tables"] = (tabs, caps)
        p.mark_down(1)
        res["down"] = _served_fields(p.replay(qs[:32], batch_size=BATCH))
        p.mark_up(1)
        res["recovered"] = _served_fields(p.replay(qs[:32], batch_size=BATCH))
        res["reshard"] = _live_reshard(p, qs)
        res["after"] = _served_fields(p.replay(qs, batch_size=BATCH))
        res["cuts"] = p.cuts.tolist()
        res["replica_dispatches"] = p.replicas.dispatches
        return res

    out["plane"], n = _section(rt, plane)
    launches.append(n)
    return launches


def _served_fields(served) -> list:
    return [(s.rid, s.batch_size, sharded_fields(s.result))
            for s in sorted(served, key=lambda s: s.rid)]


def _live_reshard(plane, qs) -> tuple:
    """The first boundary moved by one range, cut over between drains of
    two queries each; (served, steps, cuts)."""
    cuts = plane.cuts.copy()
    cuts[1] += 1 if cuts[1] + 1 < cuts[2] else -1
    task = plane.start_reshard(cuts)
    served, qi = [], 0
    while plane.reshard_task is not None or plane.pending:
        for q in qs[qi % len(qs):qi % len(qs) + 2]:
            plane.submit(q)
        qi += 2
        served.extend(plane.drain_once())
    return _served_fields(served), task.steps_done, plane.cuts.tolist()


def mesh_case_ir(rt, job, out) -> list:
    """Eight ranks: the partitioned IR on a 2 x 4 (data x model) context;
    every rank calls the step (SPMD) with the global arrays on the host,
    each moving its own sub-index to its device."""
    import torch
    from repro_torch.distributed import sharding as ms
    from repro_torch.kernels.range_scorer import kernel
    from repro_torch.serve.distributed_ir import ShardedIndexArrays, sharded_anytime_query

    arrays = ShardedIndexArrays(**{f: torch.from_numpy(a) for f, a in job["stacked"].items()},
                                s_pad=job["s_pad"], k=job["k"])
    ctx = ms.ShardCtx(ms.make_mesh(MESH_IR, ("data", "model")))
    kernel.traverse.launches = 0
    res = {}
    for label, budget in (("unbudgeted", 2**31 - 1), ("budgeted", IR_BUDGET)):
        t0 = time.perf_counter()
        v, i, r = sharded_anytime_query(arrays, job["tables"], ctx, budget)
        res[label] = dict(vals=v.cpu().numpy(), ids=i.cpu().numpy(), ranges=int(r),
                          wall_ms=(time.perf_counter() - t0) * 1e3)
    out["ir"] = res
    return [kernel.traverse.launches]


def mesh_case_nccl(rt, job, out) -> list:
    """One rank with its own card: NCCL, the preset's one shard on the mesh."""
    from repro_torch.core.range_daat import Engine
    from repro_torch.serving import BucketSpec, ShardedBatchEngine, ShardedEngine

    pe = Engine.from_artifact(job["preset_art"], k=10, device=rt.device)
    seng = ShardedEngine(pe, 1, use_mesh=True)
    check(seng.mesh is not None, "nccl: the engine is not on the mesh")

    def run():
        sb = ShardedBatchEngine(seng, BucketSpec(max_batch=BATCH))
        plans = [seng.plan(q) for q in job["preset_queries"]]
        got = sb.run_batch(plans, budget_postings=job["preset_budgets"])
        return dict(fields=[sharded_fields(r) for r in got], dispatches=sb.batches_run)

    out["nccl"], n = _section(rt, run)
    return [n]


MESH_CASES = {"serve": mesh_case_serve, "ir": mesh_case_ir, "nccl": mesh_case_nccl}


def spawn_mesh(case: str, world: int, job: dict, device: str | None = None) -> dict:
    """Run ``case`` on ``world`` spawned ranks; rank 0's record. Every rank
    is joined, or killed at ``MESH_TIMEOUT_S``."""
    import multiprocessing as mp

    for suffix in (".init", ".out"):
        (MESH_DIR / f"{case}{suffix}").unlink(missing_ok=True)
    _pickle(MESH_DIR / f"{case}.in", job)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=mesh_rank, args=(case, r, world, str(SRC), device))
             for r in range(world)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(max(1.0, MESH_TIMEOUT_S - (time.perf_counter() - t0)))
    finally:
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    check(not hung, f"mesh {case}: ranks {hung} still running after {MESH_TIMEOUT_S} s")
    codes = [p.exitcode for p in procs]
    check(all(c == 0 for c in codes), f"mesh {case}: rank exit codes {codes}")
    out = _unpickle(MESH_DIR / f"{case}.out")
    out["wall_s"] = time.perf_counter() - t0
    return out


def mesh_phase(engine, queries, art: str, shards_art: str, preset_art: str, dev,
               n: int = CONTROL_QUERIES, device: str | None = None) -> dict:
    """The retrieval mesh on ``torch.distributed`` ranks that share the card
    through gloo (host-staged collectives), plus a one-rank NCCL mesh.

    (a) Four ranks, each loading its own shard of the scale cell's shard
    artifact: ``ShardedBatchEngine`` over the mesh engine at batch ``BATCH``
    for ``n`` queries, unbudgeted, budgeted and with shard 1 starved, equal
    on every ``ShardedResult`` field to the parent's stacked
    ``ShardedEngine`` on the card, one ``traverse`` launch per rank and
    dispatch, the starved shard's exit reasons intact; then
    ``ControlPlane(n_replicas=2)`` on the 2 x 2 (data x shard) mesh over
    the preset: healthy, a batch of 3 over two replica rows, shard 1 down
    and recovered, a live reshard, each equal to the single-replica plane
    on the card. (b) Eight ranks: the partitioned IR on a 2 x 4 context
    equal to the one-device ``sharded_anytime_query`` bitwise. (c) One
    rank, NCCL. Logged: the backend, each rank's device, each group's
    wall time, the per-dispatch split between the local ``traverse`` and
    the gather and merge, and whether gloo takes card tensors directly.
    """
    import numpy as np
    import torch
    from repro_torch import index_io
    from repro_torch.control import ControlPlane
    from repro_torch.core.range_daat import Engine
    from repro_torch.serve.distributed_ir import ShardedIndexArrays, sharded_anytime_query
    from repro_torch.serving import BucketSpec, ShardedBatchEngine, ShardedEngine

    t_phase = time.perf_counter()
    rng = np.random.default_rng(23)
    qs = list(queries[:n])
    plans = [engine.plan(q) for q in qs]
    budgets = rng.integers(200, 4000, size=len(qs))
    starved = np.full((len(qs), SHARDS), 2**31 - 1, np.int64)
    starved[:, 1] = MESH_STARVED
    pe = Engine.from_artifact(preset_art, k=10, device=dev)
    pqs = list(_unpickle(MESH_DIR / "preset_queries.pkl"))[:n]
    pbudgets = rng.integers(100, 3000, size=len(pqs))
    out = {}

    # (a) the scale shards and the replica plane, four ranks.
    got = spawn_mesh("serve", SHARDS, dict(art=art, shards_art=shards_art,
                                          preset_art=preset_art, queries=qs,
                                          budgets=budgets, starved=starved,
                                          preset_queries=pqs), device=device)
    bspec = BucketSpec(max_batch=BATCH)
    stacked = ShardedBatchEngine(ShardedEngine(engine, SHARDS,
                                               shards=index_io.load_shards(shards_art)),
                                 bspec)
    dispatches = 0
    for label, kw in (("unbudgeted", {}), ("budgeted", dict(budget_postings=budgets)),
                      ("starved", dict(budget_postings=starved))):
        want = [sharded_fields(r) for r in stacked.run_batch(plans, **kw)]
        mine = got["sharded"][label]
        for i, (g, w) in enumerate(zip(mine["fields"], want)):
            check(g == w, f"mesh sharded {label} query {i}: {g} != stacked {w}")
        check(len(mine["fields"]) == len(want), f"mesh sharded {label}: lengths")
        dispatches += mine["dispatches"]
    starved_exits = sum(f[5][1] == "budget" for f in got["sharded"]["starved"]["fields"])
    check(starved_exits > 0, "mesh sharded: no budget exit of the starved shard survived")
    for r in got["ranks"]:
        check(r["launches"][0] == dispatches,
              f"mesh sharded: rank {r['rank']} launched traverse {r['launches'][0]} times "
              f"over {dispatches} dispatches")
    split = np.asarray([s for lb in ("unbudgeted", "budgeted", "starved")
                        for s in got["sharded"][lb]["split"]])
    out["sharded"] = dict(
        dispatches=dispatches, starved_budget_exits=int(starved_exits),
        load_s=got["load_s"], devices=[r["device"] for r in got["ranks"]],
        build_s=[r["build_s"] for r in got["ranks"]], backend=got["backend"],
        staged=got["staged"], gloo_cuda=got["gloo_cuda"], wall_s=got["wall_s"],
        start_s=got["start_s"], local_rows=got["local_rows"],
        traverse_ms=float(np.median(split[:, 0])), merge_ms=float(np.median(split[:, 1])),
        traverse_ms_mean=float(split[:, 0].mean()), merge_ms_mean=float(split[:, 1].mean()),
        window_ms={lb: got["sharded"][lb]["wall_ms"] for lb in
                   ("unbudgeted", "budgeted", "starved")})
    log(f"mesh (a): {SHARDS} ranks, {got['backend']}"
        f"{' host-staged' if got['staged'] else ''} on "
        f"{','.join(out['sharded']['devices'])}; each loaded its own shard "
        f"({got['local_rows']} row on its device) in {got['load_s']:.2f} s, the "
        f"kernel library from the parent's build ({out['sharded']['build_s']} s); "
        f"{len(qs)} queries x 3 budget forms == the stacked ShardedEngine on every "
        f"ShardedResult field ({dispatches} dispatches, one traverse per rank each; "
        f"{starved_exits} budget exits of starved shard 1); per dispatch, median (mean): "
        f"local upload + traverse {out['sharded']['traverse_ms']:.3f} "
        f"({out['sharded']['traverse_ms_mean']:.3f}) ms, gather + merge "
        f"{out['sharded']['merge_ms']:.3f} ({out['sharded']['merge_ms_mean']:.3f}) ms "
        f"(host-staged gloo on one shared card, "
        f"not a figure for a node with four cards); gloo on card tensors: "
        f"{got['gloo_cuda']}")

    single = ControlPlane(pe, n_shards=MESH_PLANE[1], n_replicas=MESH_PLANE[0],
                          spec=bspec, use_mesh=False)
    mp_ = got["plane"]
    want = dict(healthy=_served_fields(single.replay(pqs, batch_size=BATCH)))
    tabs, caps = mp_["odd_tables"]
    want["odd"] = single.sengine.dispatch(*tabs, caps, caps).cpu().numpy().tolist()
    single.mark_down(1)
    want["down"] = _served_fields(single.replay(pqs[:32], batch_size=BATCH))
    single.mark_up(1)
    want["recovered"] = _served_fields(single.replay(pqs[:32], batch_size=BATCH))
    want["reshard"] = _live_reshard(single, pqs)
    want["after"] = _served_fields(single.replay(pqs, batch_size=BATCH))
    for key in ("healthy", "odd", "down", "recovered", "reshard", "after"):
        check(mp_[key] == want[key], f"mesh plane {key}: the 2 x 2 mesh != one replica")
    check(any("down" in f[2][5] and not f[2][7] for f in mp_["down"]),
          "mesh plane: no query served degraded while shard 1 was down")
    for r in got["ranks"]:
        check(r["launches"][1] > 0, f"mesh plane: rank {r['rank']} launched nothing")
    out["plane"] = dict(cuts=mp_["cuts"], replica_dispatches=mp_["replica_dispatches"],
                        launches=[r["launches"][1] for r in got["ranks"]])
    log(f"mesh (a): ControlPlane({MESH_PLANE[1]} shards, {MESH_PLANE[0]} replicas) on the "
        f"2 x 2 mesh over the preset == the single-replica plane on the card: healthy, "
        f"a batch of 3 on two rows, shard 1 down and recovered, a live reshard to "
        f"{mp_['cuts']} (every rank re-carved its shard); {mp_['replica_dispatches']} "
        f"replica-mesh dispatches, traverse launches per rank "
        f"{out['plane']['launches']}; group wall {got['wall_s']:.1f} s")

    # (b) partitioned IR, eight ranks on a 2 x 4 context.
    ir_job = _unpickle(MESH_DIR / "ir_in.pkl")
    got = spawn_mesh("ir", MESH_IR[0] * MESH_IR[1], ir_job, device=device)
    arrays = ShardedIndexArrays(**{f: torch.from_numpy(a)
                                   for f, a in ir_job["stacked"].items()},
                                s_pad=ir_job["s_pad"], k=ir_job["k"]).to(dev)
    ties = 0
    for label, budget in (("unbudgeted", 2**31 - 1), ("budgeted", IR_BUDGET)):
        v, i, r = (t.cpu().numpy() for t in sharded_anytime_query(arrays, ir_job["tables"],
                                                                    None, budget))
        g = got["ir"][label]
        check(g["vals"].tolist() == v.tolist() and g["ids"].tolist() == i.tolist()
              and g["ranges"] == int(r), f"mesh ir {label}: the 2 x 4 context != one device")
        ties += sum(len(row) - len(set(row)) for row in v.tolist())
    for r in got["ranks"]:
        check(r["launches"][0] == 2, f"mesh ir: rank {r['rank']} launched "
              f"{r['launches'][0]} traverses over 2 calls")
    out["ir"] = dict(wall_s=got["wall_s"], tied_slots=ties,
                     call_ms={lb: got["ir"][lb]["wall_ms"] for lb in ("unbudgeted",
                                                                       "budgeted")},
                     launches=[r["launches"][0] for r in got["ranks"]])
    log(f"mesh (b): partitioned IR on a {MESH_IR[0]} x {MESH_IR[1]} context, 8 ranks, "
        f"{got['backend']}: == the one-device sharded_anytime_query on vals, ids and "
        f"ranges, unbudgeted and at {IR_BUDGET} postings ({ties} tied score slots); one "
        f"traverse per rank and call; calls {out['ir']['call_ms']} ms; group wall "
        f"{got['wall_s']:.1f} s")

    # (c) one rank, NCCL.
    pplans = [pe.plan(q) for q in pqs]
    got = spawn_mesh("nccl", 1, dict(preset_art=preset_art, preset_queries=pqs,
                                     preset_budgets=pbudgets), device=device)
    want = [sharded_fields(r) for r in ShardedBatchEngine(ShardedEngine(pe, 1), bspec)
            .run_batch(pplans, budget_postings=pbudgets)]
    check(got["nccl"]["fields"] == want, "mesh nccl: the one-rank mesh != stacked")
    check(got["ranks"][0]["launches"][0] == got["nccl"]["dispatches"],
          "mesh nccl: launches != dispatches")
    out["nccl"] = dict(backend=got["backend"], wall_s=got["wall_s"],
                       dispatches=got["nccl"]["dispatches"])
    log(f"mesh (c): one rank, {got['backend']} on {got['ranks'][0]['device']}: "
        f"{len(pqs)} budgeted preset queries == the stacked engine, one traverse per "
        f"dispatch ({got['nccl']['dispatches']}); group wall {got['wall_s']:.1f} s")
    out["launches"] = (dispatches * SHARDS + sum(out["plane"]["launches"])
                       + sum(out["ir"]["launches"]) + out["nccl"]["dispatches"])
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"mesh phase {out['wall_s']:.1f} s, {out['launches']} traverse launches on "
        f"its ranks")
    return out


def build_mips(src: str, spec: dict, seed: int = 0) -> dict:
    """Worker: ``spec["n"]`` clusterable candidates of width ``spec["dim"]``
    (``spec["centers"]`` planted directions plus noise, as the reference's
    test makes them), clustered by ``build_clustered_candidates`` into
    ``spec["clusters"]`` ranges on the CPU; numpy out, with the queries."""
    sys.path.insert(0, src)
    import numpy as np
    from repro_torch.serve.retrieval import build_clustered_candidates

    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    centers = rng.normal(0, 1, size=(spec["centers"], spec["dim"])).astype(np.float32)
    emb = centers[rng.integers(0, spec["centers"], size=spec["n"])]
    emb += 0.3 * rng.standard_normal(size=emb.shape, dtype=np.float32)
    t1 = time.perf_counter()
    cc = build_clustered_candidates(emb, spec["clusters"], seed=1, device="cpu")
    return dict(cc={f: getattr(cc, f).numpy() for f in ("emb", "ids", "lo", "hi")},
                data_s=t1 - t0, build_s=time.perf_counter() - t1,
                safe=rng.normal(0, 1, size=(16, spec["dim"])).astype(np.float32),
                multi=rng.normal(0, 1, size=(8, 4, spec["dim"])).astype(np.float32))


def mips_phase(job, dev) -> dict:
    """Anytime MIPS on the card against the CPU port on the same candidates:
    safe queries, budgeted ones (a quarter of the candidates, no safe stop)
    and multi-interest ones (J = 4): ids, ``ranges_processed``,
    ``candidates_scored`` and ``exit_safe`` equal, scores within MIPS_TOL,
    ids differing only within a tolerance tie; ms per query on each."""
    import numpy as np
    import torch
    from repro_torch.serve.retrieval import ClusteredCandidates, anytime_mips

    out = job.get()
    host = ClusteredCandidates(**{f: torch.from_numpy(a) for f, a in out["cc"].items()})
    card = ClusteredCandidates(**{f: getattr(host, f).to(dev)
                                  for f in ("emb", "ids", "lo", "hi")})
    check(torch.backends.cuda.matmul.allow_tf32 is False, "mips: TF32 is on")
    budget = MIPS["n"] // 4
    forms = {"safe": (out["safe"], {}),
             "budgeted": (out["safe"][:8], dict(budget_candidates=budget, safe_stop=False)),
             "multi-interest": (out["multi"], {})}
    res = dict(data_s=out["data_s"], build_s=out["build_s"], capacity=card.capacity,
               ranges=card.n_ranges)
    for label, (qs, kw) in forms.items():
        rows, card_ms, cpu_ms = [], [], []
        for i, q in enumerate(qs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            g = anytime_mips(card, q, k=10, **kw)
            gs, gi = g.scores.cpu().numpy(), g.ids.cpu().numpy()
            card_ms.append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            w = anytime_mips(host, q, k=10, **kw)
            cpu_ms.append((time.perf_counter() - t0) * 1e3)
            ws, wi = w.scores.numpy(), w.ids.numpy()
            ctx = f"mips {label} query {i}"
            check((g.ranges_processed, g.candidates_scored, g.exit_safe)
                  == (w.ranges_processed, w.candidates_scored, w.exit_safe),
                  f"{ctx}: counters {g[2:]} != CPU {w[2:]}")
            check(bool(np.allclose(gs, ws, rtol=MIPS_TOL, atol=MIPS_TOL)),
                  f"{ctx}: scores beyond tolerance")
            for j in np.nonzero(gi != wi)[0]:
                near = np.abs(ws - ws[j]) <= MIPS_TOL + MIPS_TOL * np.abs(ws[j])
                near[j] = False
                check(bool(near.any()), f"{ctx}: ids differ outside a tolerance tie")
            rows.append(dict(ranges=g.ranges_processed, scored=g.candidates_scored,
                             safe=g.exit_safe,
                             max_abs_err=float(np.max(np.abs(gs - ws)))))
        res[label] = dict(queries=len(qs), card_ms=card_ms, cpu_ms=cpu_ms,
                          median_card_ms=float(np.median(card_ms)),
                          median_cpu_ms=float(np.median(cpu_ms)),
                          mean_ranges=float(np.mean([r["ranges"] for r in rows])),
                          safe_exits=sum(r["safe"] for r in rows),
                          max_abs_err=max(r["max_abs_err"] for r in rows))
        log(f"anytime MIPS {label}: {len(qs)} queries over {MIPS['n']} candidates "
            f"(D {MIPS['dim']}, {card.n_ranges} ranges, capacity {card.capacity}): card == "
            f"CPU port (counters exact, scores within {MIPS_TOL}, largest |err| "
            f"{res[label]['max_abs_err']:.3g}); mean ranges {res[label]['mean_ranges']:.1f}, "
            f"{res[label]['safe_exits']} safe exits; median ms a query card "
            f"{res[label]['median_card_ms']:.2f}, CPU {res[label]['median_cpu_ms']:.2f}")
    return res


# ----------------------------------------------------------- architectures

LM_NAMES = ("qwen3-4b", "qwen2.5-3b", "deepseek-67b", "deepseek-v3-671b",
            "moonshot-v1-16b-a3b")
REC_NAMES = ("bst", "mind", "autoint", "bert4rec")
ARCH_TOL = (1e-4, 1e-5)  # (rtol, atol): the card against the CPU port, float32, TF32 off
LOGIT_TOL = 5e-2  # relative L2 of bfloat16 logits: cached decode against an uncached pass
# Published widths; what is cut is listed in each plan's "reduced".
LM_PLANS = {
    "qwen3-4b": dict(
        cut={}, prefill=(1, 32768), decode=(8, 32768, 16384), consistency=8192,
        reduced=["prefill_32k batch 32 -> 1", "decode_32k batch 128 -> 8 (the "
                 "cache at 128 is 618 GB; at 8, 38.7 GB beside 8.8 GB of weights)"]),
    "deepseek-v3-671b": dict(
        cut=dict(n_layers=2, n_dense_layers=1), prefill=(1, 32768),
        decode=(4, 32768, 16384), consistency=512,
        reduced=["depth 61 -> 2 layers (1 dense, 1 MoE; the MTP head kept): ~29.7 GB",
                 "prefill_32k batch 32 -> 1", "decode_32k batch 128 -> 4 (MLA expands "
                 "the compressed cache to per-head K/V every call: ~7 GB a batch row "
                 "a layer)", "decode consistency at 512 tokens with capacity_factor "
                 "= n_experts / top_k (no drops; a drop depends on the batch)"]),
}
DECODE_STEPS = 5
# Bytes a float32 attention score costs the reference's form: the product
# writes 4, the scale and the mask read and write 8 each, the softmax reads
# and writes 12, the bfloat16 cast 6, the weighted sum reads 2.
SCORE_BYTES = 40
FP32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores (data sheet)
BF16_FLOPS = 989e12  # H100 SXM dense bfloat16 on the tensor cores (data sheet)
MIPS_CLUSTERS = 64  # MIND's candidates in anytime MIPS: k-means ranges
REC_ITERS = {"serve_p99": 10, "serve_bulk": 2, "retrieval_cand": 3}


class RoutingLog:
    """While open, ``transformer.moe_ffn`` records each call's routing
    (``topi``, the slots each expert took, the capacity and the slots
    dropped past it) before it runs unchanged. Measurement only: the extra
    ``_route`` is one [T, d] x [d, E] product a call."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        import torch
        from repro_torch.models import moe, transformer

        self._orig = orig = transformer.moe_ffn

        def logged(params, x2d, cfg, shard_ctx=None):
            _, topi, _ = moe._route(params["router"], x2d, cfg)
            cap = moe._capacity(x2d.shape[0], cfg)
            rank = moe._dispatch_ranks(topi.reshape(-1), cfg.n_experts)
            self.calls.append(dict(
                topi=topi.cpu(), capacity=cap, drops=int((rank >= cap).sum()),
                counts=torch.bincount(topi.reshape(-1), minlength=cfg.n_experts).cpu()))
            return orig(params, x2d, cfg, shard_ctx)

        transformer.moe_ffn = logged
        return self

    def __exit__(self, *exc):
        from repro_torch.models import transformer

        transformer.moe_ffn = self._orig

    def summary(self, moe_cfg) -> dict:
        import torch

        counts = torch.stack([c["counts"] for c in self.calls]).sum(0)
        slots = int(counts.sum())
        share = counts.double() / max(slots, 1)
        drops = sum(c["drops"] for c in self.calls)
        return dict(calls=len(self.calls), slots=slots, capacity=self.calls[0]["capacity"],
                    drops=drops, drop_share=drops / max(slots, 1),
                    share_min=float(share.min()), share_max=float(share.max()),
                    share_mean=1.0 / moe_cfg.n_experts, experts_unused=int((counts == 0).sum()),
                    share=share.tolist())


def _sync_s(fn):
    """Host seconds of ``fn()`` with the card drained before and after."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _finite(t) -> bool:
    import torch

    return bool(torch.isfinite(t.float()).all())


def fill_sizes(n: int, chunk: int = 4096, sub: int = 512) -> list[int]:
    """Prefill pieces for ``n`` tokens whose attention keeps query chunks of
    ``sub``: whole ``chunk``s, then a multiple of ``sub``, then the rest
    (a length not a multiple of ``sub`` runs as one query chunk)."""
    sizes = [chunk] * (n // chunk)
    r = n % chunk
    sizes += [r // sub * sub] if r >= sub else []
    sizes += [r % sub] if r % sub else []
    return sizes


def decode_consistency(arch, cfg, params, dev, n: int, cache_len: int) -> dict:
    """A token appended at position ``n - 1`` by the ``decode_32k`` step
    (its cache filled by prefill pieces) has the logits of one uncached
    ``lm_forward`` over the ``n`` tokens at that position, within
    ``LOGIT_TOL`` (relative L2, bfloat16)."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.models import transformer
    from repro_torch.models.layers import dot_f32

    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    tokens = np.random.default_rng(QUERY_SEED + 1).integers(
        0, cfg.vocab, size=(1, n)).astype(np.int32)
    cache = transformer.init_cache(cfg, 1, cache_len, device=dev)
    c0 = 0
    for size in fill_sizes(n - 1):
        _, cache = transformer.lm_decode_step(params, tokens[:, c0:c0 + size], cache, c0,
                                              cfg, logits_last_only=True)
        c0 += size
    decode, _ = arch.build_step(cfg, "decode_32k")
    got, _ = decode(params, {"tokens": tokens[:, n - 1:], "cache": cache,
                             "pos": np.int32(n - 1)})
    del cache
    h, _ = transformer.lm_forward(params, tokens, cfg)
    want = dot_f32(h[:, -1:], params["lm_head"])
    rel = float(torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want))
    same_top1 = bool((got.argmax(-1) == want.argmax(-1)).all())
    check(_finite(got) and rel <= LOGIT_TOL,
          f"{arch.name}: decode at {n - 1} != an uncached pass over {n} tokens "
          f"(relative L2 {rel:.3g} > {LOGIT_TOL})")
    return dict(tokens=n, pieces=fill_sizes(n - 1), cache_len=cache_len, rel_l2=rel,
                same_top1=same_top1, max_abs=float((got - want).abs().max()))


def lm_full(dev, name: str) -> dict:
    """One LM at published widths (depth cut where ``LM_PLANS`` says):
    ``prefill_32k`` (tokens/s, the MoE routing), ``decode_32k`` (ms a step),
    decode consistency, peak device memory."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs.registry import ARCHS
    from repro_torch.models import transformer

    plan = LM_PLANS[name]
    arch = ARCHS[name]
    cfg = dataclasses.replace(arch.model_config(), **plan["cut"])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params, init_s = _sync_s(lambda: arch.init_params(0, cfg, device=dev))
    res = dict(reduced=plan["reduced"], n_layers=cfg.n_layers, d_model=cfg.d_model,
               params=sum(p.numel() for p in params.parameters()),
               param_bytes=sum(p.numel() * p.element_size() for p in params.parameters()),
               init_s=init_s)
    rng = np.random.default_rng(QUERY_SEED)
    B, S = plan["prefill"]
    prefill, _ = arch.build_step(cfg, "prefill_32k")
    tokens = rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32)
    _, warm_s = _sync_s(lambda: prefill(params, {"tokens": tokens[:, :4096]}))
    with RoutingLog() as routing:
        (logits, cache), prefill_s = _sync_s(lambda: prefill(params, {"tokens": tokens}))
    check(tuple(logits.shape) == (B, 1, cfg.vocab) and _finite(logits),
          f"{name} prefill_32k: logits {tuple(logits.shape)} not finite or misshapen")
    del cache, logits
    # Every chunk scores against the whole S-slot cache, on every head.
    scores = cfg.n_layers * B * S * S * cfg.attn.n_heads
    qk = getattr(cfg.attn, "head_dim", None) or (cfg.attn.qk_nope_head_dim
                                                 + cfg.attn.qk_rope_head_dim)
    res["prefill"] = dict(batch=B, seq=S, chunks=S // min(4096, S), s=prefill_s,
                          warm_one_chunk_s=warm_s, tokens_per_s=B * S / prefill_s,
                          scores=scores,
                          score_bytes_bound_s=scores * SCORE_BYTES / HBM_BYTES_PER_S,
                          score_flops_bound_s=2 * scores * qk / FP32_FLOPS)
    if routing.calls:
        res["routing"] = routing.summary(cfg.moe)
    B, cache_len, pos = plan["decode"]
    decode, _ = arch.build_step(cfg, "decode_32k")
    batch = dict(tokens=rng.integers(0, cfg.vocab, size=(B, 1)).astype(np.int32),
                 cache=transformer.init_cache(cfg, B, cache_len, device=dev),
                 pos=np.int32(pos))
    decode(params, batch)
    step_ms = []
    for i in range(DECODE_STEPS):
        batch = dict(batch, tokens=rng.integers(0, cfg.vocab, size=(B, 1)).astype(np.int32),
                     pos=np.int32(pos + 1 + i))
        (logits, _), s = _sync_s(lambda: decode(params, batch))
        step_ms.append(s * 1e3)
        check(tuple(logits.shape) == (B, 1, cfg.vocab) and _finite(logits),
              f"{name} decode_32k: logits not finite or misshapen")
    del batch, logits
    res["decode"] = dict(batch=B, cache_len=cache_len, pos=pos, ms_per_step=step_ms,
                         median_ms=float(np.median(step_ms)),
                         tokens_per_s=B / (float(np.median(step_ms)) / 1e3))
    res["consistency"] = decode_consistency(arch, cfg, params, dev, plan["consistency"],
                                            cache_len)
    res["max_memory_bytes"] = torch.cuda.max_memory_allocated()
    del params
    torch.cuda.empty_cache()
    routed = res.get("routing")
    log(f"arch {name} at published widths ({cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{res['params']} parameters, {res['param_bytes']} B; reduced: "
        f"{'; '.join(plan['reduced'])}): prefill_32k batch {plan['prefill'][0]} x "
        f"{plan['prefill'][1]} ({res['prefill']['chunks']} chunks) in "
        f"{prefill_s:.2f} s = {res['prefill']['tokens_per_s']:.0f} tokens/s ({scores} "
        f"float32 scores: {res['prefill']['score_bytes_bound_s']:.2f} s by their bytes, "
        f"{res['prefill']['score_flops_bound_s']:.2f} s by their products); decode_32k "
        f"batch {res['decode']['batch']} at pos {pos} of {cache_len}: "
        f"{res['decode']['median_ms']:.2f} ms a step; decode == an uncached pass over "
        f"{plan['consistency']} tokens (relative L2 {res['consistency']['rel_l2']:.3g}, "
        f"top-1 same {res['consistency']['same_top1']}); peak "
        f"{res['max_memory_bytes'] / 2**30:.2f} GiB"
        + ("" if routed is None else
           f"; routing over {routed['slots']} slots: expert share "
           f"{routed['share_min']:.5f}-{routed['share_max']:.5f} (mean "
           f"{routed['share_mean']:.5f}), {routed['drops']} slots dropped past capacity "
           f"{routed['capacity']} ({routed['drop_share']:.4f})"))
    return res


def _card_copy(params, dev):
    import copy

    return copy.deepcopy(params).to(dev)


def _allclose(got, want) -> bool:
    import torch

    return bool(torch.allclose(got.cpu(), want, rtol=ARCH_TOL[0], atol=ARCH_TOL[1]))


def reduced_parity(dev) -> dict:
    """(ii) Each reduced LM and recsys config on the card equals the same
    port run on the CPU with the same weights, float32, TF32 off: every
    serve step's output (LM: logits and the cache after; both variants)
    within ``ARCH_TOL``, every MoE call's ``topi`` exactly."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import ARCHS

    check(torch.backends.cuda.matmul.allow_tf32 is False, "arch parity: TF32 is on")
    res = {}
    for name in LM_NAMES:
        arch = ARCHS[name]
        cfg = arch.model_config(True)
        cpu = arch.init_params(0, cfg, device="cpu")
        card = _card_copy(cpu, dev)
        routed = 0
        for shape in ("prefill_32k", "decode_32k"):
            for variant in arch.variants:
                step, _ = arch.build_step(cfg, shape, variant=variant)
                host = arch.make_batch(cfg, shape, seed=1, device="cpu")
                if shape == "decode_32k":
                    rng = np.random.default_rng(2)
                    for seg in host["cache"].values():
                        for k in seg:
                            seg[k] = torch.from_numpy(
                                rng.standard_normal(seg[k].shape).astype(np.float32))
                on_card = dict(host, cache={s: {k: t.to(dev) for k, t in seg.items()}
                                            for s, seg in host["cache"].items()}) \
                    if shape == "decode_32k" else host
                with RoutingLog() as rc:
                    g_logits, g_cache = step(card, on_card)
                with RoutingLog() as rh:
                    w_logits, w_cache = step(cpu, host)
                ctx = f"arch parity {name} {shape} {variant}"
                check(_allclose(g_logits, w_logits), f"{ctx}: logits card != CPU")
                for s in w_cache:
                    for k in w_cache[s]:
                        check(_allclose(g_cache[s][k], w_cache[s][k]),
                              f"{ctx}: cache {s}/{k} card != CPU")
                check(len(rc.calls) == len(rh.calls) and all(
                    a["topi"].tolist() == b["topi"].tolist()
                    for a, b in zip(rc.calls, rh.calls)), f"{ctx}: MoE topi card != CPU")
                routed += len(rc.calls)
        res[name] = dict(cases=2 * len(arch.variants), moe_calls=routed)
    for name in REC_NAMES:
        arch = ARCHS[name]
        cfg = arch.model_config(True)
        cpu = arch.init_params(0, cfg, device="cpu")
        card = _card_copy(cpu, dev)
        for shape in ("serve_p99", "serve_bulk", "retrieval_cand"):
            step, _ = arch.build_step(cfg, shape)
            batch = arch.make_batch(cfg, shape, seed=1)
            check(_allclose(step(card, batch), step(cpu, batch)),
                  f"arch parity {name} {shape}: card != CPU")
        res[name] = dict(cases=3)
    log("arch parity: the five reduced LM configs (prefill_32k and decode_32k, both "
        "variants, logits and caches) and the four reduced towers (three shapes) on the "
        f"card == the CPU port with the same weights (float32, TF32 off, rtol "
        f"{ARCH_TOL[0]}, atol {ARCH_TOL[1]}); MoE topi exact over "
        f"{sum(r.get('moe_calls', 0) for r in res.values())} routed calls")
    return res


def build_mips_rows(src: str, rows, clusters: int) -> dict:
    """Worker: ``build_clustered_candidates`` over ``rows`` on the CPU."""
    sys.path.insert(0, src)
    from repro_torch.serve.retrieval import build_clustered_candidates

    t0 = time.perf_counter()
    cc = build_clustered_candidates(rows, clusters, seed=1, device="cpu")
    return dict(cc={f: getattr(cc, f).numpy() for f in ("emb", "ids", "lo", "hi")},
                build_s=time.perf_counter() - t0)


def recsys_full(dev, pool) -> dict:
    """The four towers at their published configs: ms a batch and examples/s
    at ``serve_p99`` and ``serve_bulk``, ms a query at ``retrieval_cand``
    (1,000,000 candidates), peak memory; the batch lies on the card. Then
    MIND's top-10 from ``rec_retrieval_scores`` against anytime MIPS's safe
    top-10 over the same candidates' rows and the same four interests."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import ARCHS
    from repro_torch.models.layers import topk_first
    from repro_torch.models.recsys import rec_user_embedding
    from repro_torch.serve.retrieval import ClusteredCandidates, anytime_mips

    res, mind = {}, None
    for name in REC_NAMES:
        arch = ARCHS[name]
        cfg = arch.model_config()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        params, init_s = _sync_s(lambda: arch.init_params(0, cfg, device=dev))
        row = dict(init_s=init_s, param_bytes=sum(p.numel() * p.element_size()
                                                  for p in params.parameters()))
        for shape in ("serve_p99", "serve_bulk", "retrieval_cand"):
            step, _ = arch.build_step(cfg, shape)
            host = arch.make_batch(cfg, shape, seed=QUERY_SEED)
            batch = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
            out = step(params, batch)
            n = batch["candidates"].shape[0] if shape == "retrieval_cand" else \
                batch[next(iter(batch))].shape[0]
            check(tuple(out.shape) == (n,) and _finite(out),
                  f"{name} {shape}: scores {tuple(out.shape)} not finite or misshapen")
            ms = [_sync_s(lambda: step(params, batch))[1] * 1e3
                  for _ in range(REC_ITERS[shape])]
            med = float(np.median(ms))
            row[shape] = dict(batch=int(batch[next(iter(batch))].shape[0]), n=n, ms=ms,
                              median_ms=med, per_s=n / (med / 1e3))
            if name == "mind" and shape == "retrieval_cand":
                feats = {"history": batch["history"]}
                u = rec_user_embedding(params, feats, cfg)[0]
                rows = params["item_emb"][batch["candidates"].long()].cpu().numpy()
                mind = dict(scores=out, interests=u,
                            job=pool.apply_async(build_mips_rows,
                                                 (str(SRC), rows, MIPS_CLUSTERS)))
        row["max_memory_bytes"] = torch.cuda.max_memory_allocated()
        res[name] = row
        log(f"arch {name} (published config): " + "; ".join(
            f"{s} {row[s]['median_ms']:.3f} ms = {row[s]['per_s']:.0f} "
            f"{'candidates' if s == 'retrieval_cand' else 'examples'}/s"
            for s in ("serve_p99", "serve_bulk", "retrieval_cand"))
            + f"; peak {row['max_memory_bytes'] / 2**30:.2f} GiB")
        del params
    out = mind["job"].get()
    cc = ClusteredCandidates(**{f: torch.from_numpy(a).to(dev) for f, a in out["cc"].items()})
    got = anytime_mips(cc, mind["interests"], k=10)
    want_v, want_i = topk_first(mind["scores"], 10)
    gv, gi = got.scores.cpu().numpy(), got.ids.cpu().numpy()
    wv, wi = want_v.cpu().numpy(), want_i.cpu().numpy().astype(np.int32)
    check(bool(np.allclose(gv, wv, rtol=MIPS_TOL, atol=MIPS_TOL)),
          "mind retrieval: anytime MIPS top-10 scores != rec_retrieval_scores'")
    for j in np.nonzero(gi != wi)[0]:
        near = np.abs(wv - wv[j]) <= MIPS_TOL + MIPS_TOL * np.abs(wv[j])
        near[j] = False
        check(bool(near.any()), "mind retrieval: ids differ outside a tolerance tie")
    res["mind_vs_mips"] = dict(ranges=cc.n_ranges, ranges_processed=got.ranges_processed,
                               ranges_skipped=cc.n_ranges - got.ranges_processed,
                               candidates_scored=got.candidates_scored,
                               exit_safe=got.exit_safe, build_s=out["build_s"],
                               max_abs_err=float(np.max(np.abs(gv - wv))),
                               ids_equal=bool((gi == wi).all()))
    m = res["mind_vs_mips"]
    log(f"arch mind retrieval_cand top-10 == anytime MIPS's safe top-10 over the same "
        f"{mind['scores'].shape[0]} rows ({cc.n_ranges} k-means ranges, worker build "
        f"{m['build_s']:.1f} s): "
        f"ids equal {m['ids_equal']} (else tolerance ties), max |score err| "
        f"{m['max_abs_err']:.3g}; the safe exit skipped {m['ranges_skipped']} of "
        f"{cc.n_ranges} ranges ({m['candidates_scored']} candidates scored)")
    return res


def arch_ir(arrays, tables) -> dict:
    """``ARCHS["anytime-ir"].build_step`` over the partitioned-IR index: each
    shape's step == ``sharded_anytime_query`` at its budget, bitwise, with
    one ``traverse`` launch a step."""
    from repro_torch.configs.registry import ARCHS
    from repro_torch.serve.distributed_ir import sharded_anytime_query

    arch = ARCHS["anytime-ir"]
    M, nnz = arrays.docs.shape
    cfg = dict(arch.model_config(True), n_queries=len(tables[0]), n_shards=M, nnz_loc=nnz,
               nb_loc=arrays.blk_start.shape[1], r_loc=tables[0].shape[2],
               b_width=tables[0].shape[3], s_pad=arrays.s_pad, k=arrays.k)
    res = {}
    for shape in arch.shapes():
        step, _ = arch.build_step(cfg, shape)
        reset_launches()
        got = [t.cpu() for t in step(arrays, {"tables": tables})]
        launches = read_launches()
        check_launches(launches, {"traverse": 1}, f"anytime-ir {shape}")
        budget = cfg["nnz_loc"] // 64 if shape == "serve_anytime" else 2**31 - 1
        want = [t.cpu() for t in sharded_anytime_query(arrays, tables, None, budget)]
        for label, g, w in zip(("vals", "ids", "ranges"), got, want):
            check(g.dtype == w.dtype and g.tolist() == w.tolist(),
                  f"anytime-ir {shape}: {label} != sharded_anytime_query's")
        res[shape] = dict(budget=budget, launches=launches["traverse"],
                          ranges=int(got[2]))
    res["dry"] = ir_dry_spec(arrays, tables, cfg)
    log(f"arch anytime-ir through the registry ({len(tables[0])} queries x {M} shards): "
        f"serve_anytime (budget {res['serve_anytime']['budget']} postings a lane, "
        f"{res['serve_anytime']['ranges']} lane-ranges) and serve_exhaustive "
        f"({res['serve_exhaustive']['ranges']}) == sharded_anytime_query bitwise, one "
        "traverse a step")
    return res


def arch_phase(dev, pool) -> dict:
    """The architecture registry on the card: the reduced configs against the
    CPU port, the LMs and the towers at published widths."""
    import torch

    t0 = time.perf_counter()
    res = dict(parity=reduced_parity(dev))
    for name in LM_PLANS:
        res[name] = lm_full(dev, name)
    res["recsys"] = recsys_full(dev, pool)
    torch.cuda.empty_cache()
    res["wall_s"] = time.perf_counter() - t0
    log(f"arch phase {res['wall_s']:.1f} s")
    return res


# ---------------------------------------------------------------- training

TRAIN_STEPS = 3  # steps of each reduced train shape, card against CPU
TRAIN_MOMENTS = ("fp32", "bf16", "int8")  # on TRAIN_MOMENTS_LM, through make_train_step
TRAIN_MOMENTS_LM = "deepseek-v3-671b"
# Published widths; what is cut is listed under "reduced".
TRAIN_FULL = dict(
    arch="qwen3-4b", batch=1, seq=4096, warm=2, timed=4, moments="fp32",
    reduced=["train_4k global batch 256 -> 1 (one sequence of 4,096 tokens a step)"])
RESUME = dict(arch="qwen3-4b", moments="bf16", steps=4)  # reduced config, bf16 moments
GNN_PUBLISHED = ("full_graph_sm", "minibatch_lg", "ogb_products", "molecule")
REC_TRAIN_BATCH = {  # train_batch at published configs; cuts listed with reasons
    "bst": 65536, "mind": 32768, "autoint": 65536, "bert4rec": 16384}
REC_TRAIN_CUTS = {
    "mind": "train_batch 65,536 -> 32,768: the in-batch [B, B] float32 logits are "
            "17.2 GB at 65,536, and logsumexp's backward and the gold column's gather "
            "hold more of that size (out of memory at 72.5 GB allocated on an H100 "
            "80GB)",
    "bert4rec": "train_batch 65,536 -> 16,384: at 65,536 the two blocks' float32 "
                "scores and probabilities (2 x [B, 2, 200, 200], 21 GB each) and the "
                "sampled softmax's [B x 20, 4,097] float32 logits (21.5 GB, kept with "
                "its concatenation) do not fit in 80 GB"}
TRAIN_ITERS = 3  # timed steps of each published GraphSAGE shape and tower, after one


def _close_updated(got, want, lr_sum: float, tol=ARCH_TOL) -> bool:
    """Parameters after AdamW updates on the card against the CPU: within
    ``tol``, except elements whose gradient lies within the two devices'
    float32 difference of 0: their update ``lr (g / (|g| + eps) + wd p)``
    may take either sign, bounded by lr (1 + wd |p|) on each side, so these
    (at most 0.1% of a leaf) are held within 2.2 x the lr summed over the
    steps taken."""
    import torch

    got, want = got.detach().float().cpu(), want.detach().float()
    diff = (got - want).abs()
    off = diff > tol[1] + tol[0] * want.abs()
    return bool(torch.isfinite(got).all()) and float(off.float().mean()) <= 1e-3 and \
        float(diff.max()) <= max(tol[1] + tol[0] * float(want.abs().max()), 2.2 * lr_sum)


def _routes(calls) -> list:
    return [c["topi"].tolist() for c in calls]


def train_parity_case(dev, arch, cfg, shape, step, md: str, label: str) -> dict:
    """``TRAIN_STEPS`` steps of ``step`` on the card and on the CPU from the
    same parameters and batches: loss, lr and grad_norm within ``ARCH_TOL``,
    the parameters after each step as ``_close_updated`` says, every MoE
    call's ``topi`` equal at step 1. Under int8 moments each step starts
    the card from the CPU's state (a moment one quantum apart changes later
    updates by any amount, see tests/test_torch_train_archs.py), the stored
    moments are held within one quantum, and elements whose stored second
    moment decodes to 0 are left out of the parameter check."""
    import torch
    from repro_torch.models.layers import param_leaves
    from repro_torch.optim.adamw import AdamWConfig, _dq8, init_opt_state, is_q8_leaf

    cpu = arch.init_params(0, cfg, device="cpu")
    card = _card_copy(cpu, dev)
    s_cpu = init_opt_state(cpu, AdamWConfig(moment_dtype=md))
    s_card = init_opt_state(card, AdamWConfig(moment_dtype=md))
    lr_sum, routed, worst = 0.0, 0, 0.0
    for i in range(TRAIN_STEPS):
        batch = arch.make_batch(arch.model_config(True), shape, seed=10 + i)
        v0 = {}
        if md == "int8":
            leaves = param_leaves(cpu)
            v0 = {n: _dq8(s, leaves[n]) == 0 for n, s in s_cpu["v"].items()}
        with RoutingLog() as rc:
            card, s_card, m_card = step(card, s_card, batch)
        with RoutingLog() as rh:
            cpu, s_cpu, m_cpu = step(cpu, s_cpu, batch)
        ctx = f"train parity {label} step {i + 1}"
        for k in ("loss", "lr", "grad_norm"):
            check(_allclose(m_card[k], m_cpu[k]), f"{ctx}: {k} card {float(m_card[k])} != "
                  f"CPU {float(m_cpu[k])}")
        lr_sum += float(m_cpu["lr"])
        if i == 0:
            check(len(rc.calls) == len(rh.calls) and _routes(rc.calls) == _routes(rh.calls),
                  f"{ctx}: MoE topi card != CPU")
            routed += len(rc.calls)
        want = param_leaves(cpu)
        for n, g in param_leaves(card).items():
            w = want[n]
            if n in v0 and i:
                g = torch.where(v0[n].to(dev), w.to(dev), g)
            check(_close_updated(g, w, lr_sum if md != "int8" else float(m_cpu["lr"])),
                  f"{ctx}: parameter {n} card != CPU")
            worst = max(worst, float((g.float().cpu() - w.float()).abs().max()))
        if md == "int8":
            for mom in ("m", "v"):
                for n, s in s_cpu[mom].items():
                    q = s_card[mom][n]["q"].cpu().int() - s["q"].int() if is_q8_leaf(s) \
                        else torch.zeros(1)
                    check(int(q.abs().max()) <= 1, f"{ctx}: int8 {mom} {n} beyond one quantum")
            with torch.no_grad():
                for n, p in param_leaves(card).items():
                    p.copy_(want[n])
            s_card = {"m": {n: {k: t.to(dev) for k, t in s.items()}
                            for n, s in s_cpu["m"].items()},
                      "v": {n: {k: t.to(dev) for k, t in s.items()}
                            for n, s in s_cpu["v"].items()},
                      "step": s_cpu["step"].to(dev)}
    return dict(steps=TRAIN_STEPS, moments=md, moe_calls_step1=routed,
                loss=float(m_cpu["loss"]), max_abs_param_diff=worst)


def train_parity(dev) -> dict:
    """(a) Every ``train`` shape of the registry at its reduced config
    through ``Arch.build_step``, card against CPU, float32, TF32 off; the
    three moment dtypes on one LM through ``make_train_step``."""
    import torch
    from repro_torch.configs.registry import ARCHS
    from repro_torch.models import transformer
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.trainer import make_train_step

    check(torch.backends.cuda.matmul.allow_tf32 is False, "train parity: TF32 is on")
    res = {}
    for name, arch in ARCHS.items():
        for shape, info in arch.shapes().items():
            if info.kind != "train":
                continue
            cfg = arch.model_config(True)
            rcfg = arch._resolved(cfg, shape) if arch.family == "gnn" else cfg
            step, _ = arch.build_step(cfg, shape)
            res[f"{name} {shape}"] = train_parity_case(
                dev, arch, rcfg, shape, step, arch.moment_dtype(cfg), f"{name} {shape}")
    arch = ARCHS[TRAIN_MOMENTS_LM]
    cfg = arch.model_config(True)
    for md in TRAIN_MOMENTS:
        step = make_train_step(lambda p, b: transformer.lm_loss(p, b["tokens"], cfg),
                               AdamWConfig(moment_dtype=md))
        res[f"{TRAIN_MOMENTS_LM} moments {md}"] = train_parity_case(
            dev, arch, cfg, "train_4k", step, md, f"{TRAIN_MOMENTS_LM} {md} moments")
    moe = sum(r["moe_calls_step1"] for r in res.values())
    log(f"train parity: {len(res)} cases ({len(res) - len(TRAIN_MOMENTS)} train shapes "
        f"through build_step, {TRAIN_MOMENTS_LM} at fp32/bf16/int8 moments), "
        f"{TRAIN_STEPS} steps each, card == CPU port (loss, lr, grad_norm within rtol "
        f"{ARCH_TOL[0]}, atol {ARCH_TOL[1]}; parameters likewise but for gradient-noise "
        f"elements within 2.2 lr); MoE topi exact over {moe} routed calls at step 1; "
        "largest parameter difference "
        f"{max(r['max_abs_param_diff'] for r in res.values()):.3g}")
    return res


def _lm_trainer(dev, name: str, cfg, moments: str, total: int, ckpt=None, seq=None,
                batch=None, params=None):
    """A ``Trainer`` over ``lm_loss`` with random tokens from the step."""
    import numpy as np
    from repro_torch.configs.registry import ARCHS
    from repro_torch.models import transformer
    from repro_torch.train.trainer import Trainer, TrainerConfig

    arch = ARCHS[name]
    if seq is None:
        d = arch._dims(cfg, "train_4k")
        batch, seq = d["batch"], d["seq"]

    def data_fn(step):
        rng = np.random.default_rng(QUERY_SEED + step)
        return {"tokens": rng.integers(0, cfg.vocab, size=(batch, seq)).astype(np.int32)}

    params = params if params is not None else arch.init_params(0, cfg, device=dev)
    return Trainer(lambda p, b: transformer.lm_loss(p, b["tokens"], cfg), params,
                   TrainerConfig(total_steps=total, log_every=1, checkpoint_every=2,
                                 moment_dtype=moments, warmup=1), data_fn, ckpt)


def train_full(dev) -> dict:
    """(b) qwen3-4b whole at published widths (bfloat16, fp32 moments, remat
    on), ``train_4k`` at batch 1 x 4,096 through ``Trainer``: the loss of
    each step, s a step, tokens/s and peak memory over the timed steps."""
    import math

    import numpy as np
    import torch
    from repro_torch.configs.registry import ARCHS

    plan = TRAIN_FULL
    arch = ARCHS[plan["arch"]]
    cfg = arch.model_config()
    check(cfg.remat and cfg.dtype == torch.bfloat16, "train full: remat off or not bfloat16")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    steps = plan["warm"] + plan["timed"]
    t0 = time.perf_counter()
    tr = _lm_trainer(dev, plan["arch"], cfg, plan["moments"], steps, seq=plan["seq"],
                     batch=plan["batch"])
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    out = tr.run(install_signal_handlers=False)
    hist = out["history"]
    check(out["exit"] == "completed" and len(hist) == steps,
          f"train full: {out['exit']}, {len(hist)} steps")
    losses = [h["loss"] for h in hist]
    check(all(math.isfinite(v) for v in losses), f"train full: a loss is not finite: {losses}")
    check(abs(losses[0] - math.log(cfg.vocab)) < 1.0,
          f"train full: first loss {losses[0]} far from ln(vocab) {math.log(cfg.vocab)}")
    timed = [h["time_s"] for h in hist[plan["warm"]:]]
    s_step = float(np.median(timed))
    tokens = plan["batch"] * plan["seq"]
    # Floors of the step's three heaviest parts (no profile): every query
    # chunk scores all S keys on every head in float32 (no causal skip),
    # in the forward pass, the recompute and the backward pass at
    # SCORE_BYTES a score each; the float32 products (QK^T in each pass, the
    # backward's two for each forward one; the lm head's forward and
    # backward); the bfloat16 matmuls, 2 + 2 + 4 FLOP a weight a token.
    n_params = sum(p.numel() for p in tr.params.parameters())
    head = cfg.d_model * cfg.vocab
    scores = cfg.n_layers * plan["batch"] * cfg.attn.n_heads * plan["seq"] ** 2
    f32_flops = 8 * cfg.attn.head_dim * scores + 6 * plan["batch"] * (plan["seq"] - 1) * head
    bf16_flops = 8 * (n_params - 2 * head) * tokens
    res = dict(reduced=plan["reduced"], n_layers=cfg.n_layers, d_model=cfg.d_model,
               vocab=cfg.vocab, params=sum(p.numel() for p in tr.params.parameters()),
               moments=plan["moments"], batch=plan["batch"], seq=plan["seq"],
               init_s=init_s, losses=losses, grad_norms=[h["grad_norm"] for h in hist],
               step_s=[h["time_s"] for h in hist], s_per_step=s_step,
               tokens_per_s=tokens / s_step,
               max_memory_bytes=torch.cuda.max_memory_allocated(),
               scores_per_pass=scores,
               score_bytes_bound_s=3 * scores * SCORE_BYTES / HBM_BYTES_PER_S,
               f32_flops=f32_flops, f32_flops_bound_s=f32_flops / FP32_FLOPS,
               bf16_flops=bf16_flops, bf16_flops_bound_s=bf16_flops / BF16_FLOPS)
    log(f"train full {plan['arch']} at published widths ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, vocab {cfg.vocab}, {res['params']} parameters, bfloat16, "
        f"{plan['moments']} moments, remat on; reduced: {'; '.join(plan['reduced'])}): "
        f"train_4k {plan['batch']} x {plan['seq']} through Trainer, losses "
        + ", ".join(f"{v:.4f}" for v in losses)
        + f" (ln vocab {math.log(cfg.vocab):.4f}); steps "
        + ", ".join(f"{t:.3f}" for t in res["step_s"])
        + f" s; median of the {plan['timed']} timed {s_step:.3f} s = "
        f"{res['tokens_per_s']:.0f} tokens/s; peak {res['max_memory_bytes'] / 2**30:.2f} GiB; "
        f"floors: {scores} float32 scores a pass, {res['score_bytes_bound_s']:.3f} s by "
        f"their bytes over three passes, {res['f32_flops_bound_s']:.3f} s by the float32 "
        f"products, {res['bf16_flops_bound_s']:.3f} s by the bfloat16 matmuls")
    return res, tr


def checkpoint_roundtrip(tr, directory) -> dict:
    """The full-width trainer's state saved through ``Checkpointer`` and
    restored: bytes and seconds each way, every leaf equal bit for bit.
    Skipped (and said so) when the disk lacks room."""
    import shutil

    import torch
    from repro_torch.models.layers import param_leaves
    from repro_torch.train.checkpoint import Checkpointer

    need = sum(p.numel() * p.element_size() for p in tr.params.parameters()) + sum(
        m.numel() * m.element_size() for mom in ("m", "v")
        for m in tr.opt_state[mom].values())
    free = shutil.disk_usage(ROOT).free
    if free < 1.2 * need:
        log(f"train checkpoint at full width skipped: {free} B free on disk, the state is "
            f"{need} B")
        return dict(skipped=True, free_bytes=free, state_bytes=need)
    shutil.rmtree(directory, ignore_errors=True)
    ck = Checkpointer(str(directory), keep_last=1)
    step = int(tr.opt_state["step"])
    t0 = time.perf_counter()
    state = tr._state()
    host_s = time.perf_counter() - t0
    ck.save(state, step=step, blocking=True)
    save_s = time.perf_counter() - t0
    del state
    on_disk = _dir_bytes(directory)
    t0 = time.perf_counter()
    back = ck.restore(step, device="cpu")
    read_s = time.perf_counter() - t0
    from repro_torch.models.layers import tree_to_flat

    flat = tree_to_flat(back["params"], tr.params.stacked)
    same = all(torch.equal(flat[n].to(p.device), p) for n, p in param_leaves(tr.params).items())
    m = tree_to_flat(back["opt_state"]["m"], tr.params.stacked)
    same = same and all(torch.equal(m[n].to(t.device), t) for n, t in tr.opt_state["m"].items())
    check(same, "train checkpoint at full width: a restored leaf differs")
    del back, flat, m
    shutil.rmtree(directory, ignore_errors=True)
    res = dict(skipped=False, state_bytes=need, file_bytes=on_disk, host_copy_s=host_s,
               save_s=save_s, restore_to_host_s=read_s,
               save_gb_per_s=on_disk / save_s / 1e9, restore_gb_per_s=on_disk / read_s / 1e9)
    log(f"train checkpoint at full width: {on_disk} B on disk ({need} B of state), save "
        f"{save_s:.1f} s ({host_s:.1f} s of it the device-to-host copy) = "
        f"{res['save_gb_per_s']:.2f} GB/s, restore to the host {read_s:.1f} s = "
        f"{res['restore_gb_per_s']:.2f} GB/s; every parameter and first moment equal")
    return res


def resume_phase(dev, directory) -> dict:
    """(c) A ``Trainer`` with a ``Checkpointer`` runs 4 steps (checkpoints
    at 2 and 4); a second one, restored from step 2, runs steps 3-4 with
    the uninterrupted run's losses; a preemption flag during step 3 leaves
    a checkpoint of step 3 and exits ``preempted``. Reduced qwen3-4b,
    bfloat16 moments (the ``V2`` path of the checkpoint)."""
    import shutil
    import signal

    import torch
    from repro_torch.configs.registry import ARCHS
    from repro_torch.train.checkpoint import Checkpointer

    name, md, steps = RESUME["arch"], RESUME["moments"], RESUME["steps"]
    cfg = ARCHS[name].model_config(True)
    shutil.rmtree(directory, ignore_errors=True)
    u_dir, p_dir = directory / "run", directory / "preempt"
    ck = Checkpointer(str(u_dir))
    full = _lm_trainer(dev, name, cfg, md, steps, ck).run(install_signal_handlers=False)
    check(ck.list_steps() == [2, 4], f"resume: checkpoints {ck.list_steps()}")
    shutil.rmtree(u_dir / "step_00000004")
    tr = _lm_trainer(dev, name, cfg, md, steps, Checkpointer(str(u_dir)))
    resumed = tr.run(install_signal_handlers=False)
    check([h["step"] for h in resumed["history"]] == [3, 4], "resume: did not start at 3")
    check(all(t.dtype == torch.bfloat16 for t in tr.opt_state["m"].values()),
          "resume: restored moments are not bfloat16")
    diffs = [abs(a["loss"] - b["loss"]) for a, b in zip(resumed["history"], full["history"][2:])]
    check(all(d <= ARCH_TOL[1] + ARCH_TOL[0] * abs(b["loss"])
              for d, b in zip(diffs, full["history"][2:])),
          f"resume: losses of steps 3-4 differ from the uninterrupted run by {diffs}")
    pck = Checkpointer(str(p_dir))
    pt = _lm_trainer(dev, name, cfg, md, steps, pck)
    pt.cfg.checkpoint_every = 100
    orig = pt.data_fn

    def data_fn(step):
        if step == 2:  # during the third step
            pt._handle_preemption(signal.SIGTERM, None)
        return orig(step)

    pt.data_fn = data_fn
    pout = pt.run(install_signal_handlers=False)
    check(pout["exit"] == "preempted" and pout["last_step"] == 3 and pck.list_steps() == [3],
          f"preemption: {pout['exit']} at {pout['last_step']}, checkpoints {pck.list_steps()}")
    back = pck.restore(3, device="cpu")
    check(int(back["opt_state"]["step"]) == 3, "preemption: checkpoint step != 3")
    shutil.rmtree(directory, ignore_errors=True)
    res = dict(arch=name, config="reduced", moments=md, uninterrupted=[
        h["loss"] for h in full["history"]], resumed=[h["loss"] for h in resumed["history"]],
        max_loss_diff=max(diffs), preempted_at=pout["last_step"])
    log(f"train resume ({name} reduced, {md} moments, through Checkpointer): losses "
        + ", ".join(f"{v:.6f}" for v in res["uninterrupted"]) + "; resumed from step 2: "
        + ", ".join(f"{v:.6f}" for v in res["resumed"])
        + f" (largest difference {max(diffs):.3g}); preempted during step 3 -> "
        "checkpoint of step 3, exit preempted")
    return res


def build_gnn_batch(src: str, shape: str) -> dict:
    """Worker: GraphSAGE's published ``make_batch`` for ``shape``."""
    sys.path.insert(0, src)
    from repro_torch.configs.registry import ARCHS

    arch = ARCHS["graphsage-reddit"]
    t0 = time.perf_counter()
    batch = arch.make_batch(arch.model_config(), shape, seed=QUERY_SEED)
    return dict(batch=batch, build_s=time.perf_counter() - t0)


def _train_steps(dev, arch, cfg, step, batch) -> dict:
    """One step, then ``TRAIN_ITERS`` timed steps on the card: ms a step, the
    losses, peak memory."""
    import numpy as np
    import torch
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = arch.init_params(0, cfg, device=dev)
    state = init_opt_state(params, AdamWConfig())
    batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
    losses, ms = [], []
    for i in range(1 + TRAIN_ITERS):
        (params, state, m), s = _sync_s(lambda: step(params, state, batch))
        check(_finite(m["loss"]) and _finite(m["grad_norm"]),
              f"{arch.name}: loss or grad_norm not finite")
        losses.append(float(m["loss"]))
        if i:
            ms.append(s * 1e3)
    out = dict(losses=losses, ms=ms, median_ms=float(np.median(ms)),
               max_memory_bytes=torch.cuda.max_memory_allocated(),
               param_bytes=sum(p.numel() * p.element_size() for p in params.parameters()))
    del params, state, batch
    torch.cuda.empty_cache()
    return out


def train_published(dev, jobs) -> dict:
    """(d) GraphSAGE's four shapes and the four towers' ``train_batch`` at
    published configs (cuts in ``REC_TRAIN_CUTS``): ms a step, peak memory.
    The graphs come from worker processes."""
    from repro_torch.configs.registry import ARCHS

    res = {}
    arch = ARCHS["graphsage-reddit"]
    for shape in GNN_PUBLISHED:
        out = jobs[shape].get()
        cfg = arch._resolved(arch.model_config(), shape)
        step, _ = arch.build_step(arch.model_config(), shape)
        row = _train_steps(dev, arch, cfg, step, out["batch"])
        row.update(build_s=out["build_s"], d_in=cfg.d_in, d_hidden=cfg.d_hidden,
                   **{k: int(v.shape[0]) for k, v in out["batch"].items()
                      if k in ("feats", "edges", "labels")})
        res[f"graphsage {shape}"] = row
        log(f"train graphsage-reddit {shape} (published: d_in {cfg.d_in}, hidden "
            f"{cfg.d_hidden}, {row.get('feats')} nodes, {row.get('edges', '-')} edges; "
            f"batch built in a worker in {row['build_s']:.1f} s): {row['median_ms']:.2f} ms "
            f"a step, losses {', '.join(f'{v:.4f}' for v in row['losses'])}, peak "
            f"{row['max_memory_bytes'] / 2**30:.2f} GiB")
    for name, B in REC_TRAIN_BATCH.items():
        arch = ARCHS[name]
        cfg = arch.model_config()
        step, _ = arch.build_step(cfg, "train_batch")
        host = arch.make_batch(cfg, "train_batch", seed=QUERY_SEED)
        host = {k: v[:B] for k, v in host.items()}
        row = _train_steps(dev, arch, cfg, step, host)
        row.update(batch=B, reduced=[REC_TRAIN_CUTS[name]] if name in REC_TRAIN_CUTS else [],
                   examples_per_s=B / (row["median_ms"] / 1e3))
        res[name] = row
        log(f"train {name} train_batch (published config, batch {B}"
            + (f"; reduced: {REC_TRAIN_CUTS[name]}" if name in REC_TRAIN_CUTS else "")
            + f"): {row['median_ms']:.2f} ms a step = {row['examples_per_s']:.0f} "
            f"examples/s, losses {', '.join(f'{v:.4f}' for v in row['losses'])}, peak "
            f"{row['max_memory_bytes'] / 2**30:.2f} GiB")
    return res


def train_phase(dev, pool, full_checkpoint: bool = False) -> dict:
    """Training on the card: (a) reduced parity against the CPU port, (b)
    qwen3-4b at published widths (with ``full_checkpoint``, its 44 GB
    state through a checkpoint and back: ~3.5 min of disk, so only
    ``--train`` runs it), (c) resume and preemption, (d) GraphSAGE and the
    towers at published configs. The published graphs are built in worker
    processes meanwhile."""
    import torch

    t0 = time.perf_counter()
    jobs = {s: pool.apply_async(build_gnn_batch, (str(SRC), s)) for s in GNN_PUBLISHED}
    walls = {}
    res = dict(parity=train_parity(dev))
    walls["parity"] = time.perf_counter() - t0
    full, tr = train_full(dev)
    res["full"] = full
    walls["full"] = time.perf_counter() - t0 - sum(walls.values())
    if full_checkpoint:
        res["full"]["checkpoint"] = checkpoint_roundtrip(tr, ROOT / ".cache" /
                                                         "chip_smoke_ckpt")
        walls["checkpoint"] = time.perf_counter() - t0 - sum(walls.values())
    del tr
    torch.cuda.empty_cache()
    res["resume"] = resume_phase(dev, ROOT / ".cache" / "chip_smoke_resume")
    walls["resume"] = time.perf_counter() - t0 - sum(walls.values())
    res["published"] = train_published(dev, jobs)
    walls["published"] = time.perf_counter() - t0 - sum(walls.values())
    torch.cuda.empty_cache()
    res["wall_s"] = time.perf_counter() - t0
    res["walls_s"] = walls
    log(f"train phase {res['wall_s']:.1f} s (" + ", ".join(
        f"{k} {v:.1f} s" for k, v in walls.items()) + ")")
    return res


# ------------------------------------------------------- the model mesh phase

MM_SEED = 7  # weights, caches and tokens of the model mesh phase, from seed
MM_GROUP = 4  # ranks of each model-mesh group, sharing the one card
# Published widths; what is cut is listed in each case's "reduced".
MM_PLAN = dict(
    full=True,
    decode=dict(arch="qwen3-4b", cut={}, batch=8, cache=32768, pos=16384, steps=2,
                mesh=(1, 4), f32=dict(n_layers=2),
                reduced=["decode_32k batch 128 -> 8, as the arch phase",
                         "the float32 check: depth 36 -> 2, one step"]),
    mla=dict(arch="deepseek-v3-671b", cut=dict(n_layers=2, n_dense_layers=1), batch=4,
             cache=32768, pos=16384, steps=2, chunk=128, mesh=(2, 2),
             f32=dict(n_layers=1, n_dense_layers=1),
             reduced=["depth 61 -> 2 layers (1 dense, 1 MoE), as the arch phase",
                      "the float32 check: depth 1 (dense; float32 experts would not fit "
                      "beside the comparator's), one step",
                      "decode_32k batch 128 -> 4", "one prefill chunk of 4 x 128 (with "
                      "no drops an expert's buffer holds every token)",
                      "capacity_factor = n_experts / top_k (no drops: a drop depends "
                      "on how many tokens a rank routes)"]),
    train=dict(arch="qwen3-4b", cut=dict(n_layers=4), batch=2, seq=4096, steps=3,
               after_batch=4, mesh=(2, 2), restore_mesh=(4, 1),
               reduced=["depth 36 -> 4 layers", "train_4k global batch 256 -> 2 (the step "
                        "after the restore: 4, so that it splits over 4 data ranks)"]),
    gnn=dict(shape="ogb_products", steps=2, mesh=(4, 1),
             reduced=["2 steps (the second's loss carries the first's update; a step "
                      "is ~17 s of host-staged gloo)"]),
    towers=dict(serve="serve_p99", train={"bst": 65536, "mind": 16384, "autoint": 65536,
                                          "bert4rec": 4096}, mesh=(1, 4),
                reduced=["train_batch: mind 65,536 -> 16,384 and bert4rec -> 4,096 (with "
                         "data 1 every rank runs the whole batch's dense work on the one "
                         "card)"]),
    pod=dict(n=65536, rows=8, mesh=(2, 2), reduced=[]),
)
# (c)'s bounds lie between the sound readings and those of a planted
# fault on the card (PERF.md): losses 9.1e-6 and 2.0e-4; leaf changes 0.16
# (Adam's first steps flip the sign of an update where bfloat16 rounding
# flips a near-zero gradient's) and 0.7-1.
MM_TOL = dict(logits=LOGIT_TOL, f32=1e-4, loss=LOGIT_TOL, train_loss=4e-5, train_change=0.3,
              towers=1e-4, pod=2e-2, topi_gap=1e-2)
# Leaves of (c) compared after the steps; of the two vocabulary tables a
# slice ("mid": embed's 2,048 rows about V / 2, where its ZeRO-1 rows
# split between the two data ranks).
MM_TRAIN_LEAVES = {"embed": "mid", "lm_head": (slice(None), slice(0, 2048)),
                   "final_norm": (), "dense.0.attn.wq": (), "dense.3.ffn.w_down": ()}


def _mm_train_leaves(leaves) -> dict:
    """Copies on the host (training goes on in place)."""
    import torch

    def at(x, sl):
        if sl == "mid":
            sl = (slice(max(0, x.shape[0] // 2 - 1024), x.shape[0] // 2 + 1024),)
        return x[sl]

    return {n: at(leaves[n], sl).detach().to("cpu", torch.float32, copy=True)
            for n, sl in MM_TRAIN_LEAVES.items() if n in leaves}


def mm_plan_reduced() -> dict:
    """The model mesh phase at the reduced configs, for a CPU rehearsal."""
    return dict(
        full=False,
        decode=dict(MM_PLAN["decode"], batch=4, cache=64, pos=32),
        mla=dict(MM_PLAN["mla"], cut={}, batch=4, cache=64, pos=32, chunk=16),
        train=dict(MM_PLAN["train"], cut={}, batch=4, seq=64, after_batch=4),
        gnn=dict(MM_PLAN["gnn"]),
        towers=dict(MM_PLAN["towers"], train={"bst": 64, "mind": 64, "autoint": 64,
                                              "bert4rec": 32}),
        pod=dict(MM_PLAN["pod"], n=1024))


def _mm_cfg(plan, case: str, f32: bool = False):
    """The case's arch and config; with ``f32`` its float32 shallow cut."""
    import dataclasses

    import torch
    from repro_torch.configs.registry import ARCHS

    p = plan[case]
    arch = ARCHS[p["arch"]]
    cfg = dataclasses.replace(arch.model_config(not plan["full"]), **p["cut"])
    if f32:
        cfg = dataclasses.replace(cfg, **p["f32"], dtype=torch.float32)
    if case == "mla" and cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    return arch, cfg


def _mm_tokens(cfg, rows: int, cols: int, salt: int):
    import numpy as np

    return np.random.default_rng(MM_SEED + salt).integers(
        0, cfg.vocab, size=(rows, cols)).astype(np.int32)


_MM_NORMS = ("ln1", "ln2", "final_norm", "q_norm", "k_norm", "kv_norm", "ln_h", "ln_e")


def _mm_rows(name: str, shape, dtype, lo: int, hi: int, dev):
    """Rows [lo, hi) of leaf ``name``, drawn in fixed chunks of its leading
    dim, each from a generator of its own: any rank draws the rows it keeps
    and nothing more. N(0, 1 / shape[-2]) for a matrix (``dense_init``'s
    scale), ones for a norm, zeros for a bias."""
    import zlib

    import torch

    leaf = name.split(".")[-1]
    if len(shape) == 1 and (leaf in _MM_NORMS or leaf.startswith("b")):
        fill = 1.0 if leaf in _MM_NORMS else 0.0
        return torch.full((hi - lo,), fill, dtype=dtype, device=dev)
    row = 1
    for d in shape[1:]:
        row *= d
    per = max(1, (1 << 26) // max(row, 1))  # 64 Mi values a chunk
    std = 1.0 / (shape[-2] if len(shape) > 1 else shape[0]) ** 0.5
    out = torch.empty((hi - lo, *shape[1:]), dtype=dtype, device=dev)
    for k in range(lo // per, (hi + per - 1) // per):
        a, b = k * per, min((k + 1) * per, shape[0])
        g = torch.Generator(device=dev).manual_seed(
            (MM_SEED * 1_000_003 + zlib.crc32(name.encode()) * 4099 + k) % (1 << 62))
        x = torch.randn((b - a, *shape[1:]), generator=g, device=dev)
        x.mul_(std)
        s0, s1 = max(a, lo), min(b, hi)
        out[s0 - lo:s1 - lo] = x[s0 - a:s1 - a].to(dtype)
        del x
    return out


def mm_init(arch, cfg, dev, specs=None, mesh=None):
    """The seed's parameters of ``arch`` at ``cfg``, leaf by leaf on
    ``dev``: whole, or with ``specs`` and ``mesh`` this rank's blocks only
    (a rank draws the leading-dim rows of its block and slices the rest)."""
    from repro_torch.distributed import sharding as ms
    from repro_torch.models.layers import param_leaves

    params = arch.param_shapes(cfg)
    for name, meta in param_leaves(params).items():
        lo, hi = 0, meta.shape[0] if meta.ndim else 1
        spec = ms.spec_at(specs, name.split(".")) if specs is not None else ms.P()
        lead = tuple(spec)[0] if len(tuple(spec)) else None
        if lead is not None and meta.ndim:
            idx, n = ms.mesh_coord(mesh, lead)
            lo, hi = idx * meta.shape[0] // n, (idx + 1) * meta.shape[0] // n
        x = _mm_rows(name, tuple(meta.shape), meta.dtype, lo, hi, dev) if meta.ndim else \
            _mm_rows(name, (1,), meta.dtype, 0, 1, dev).reshape(())
        if specs is not None and len(tuple(spec)) > 1:
            x = ms.place(x, ms.P(None, *tuple(spec)[1:]), mesh, dev)
        *mods, leaf = name.split(".")
        owner = params
        for m_ in mods:
            owner = owner._modules[m_]
        import torch

        owner._parameters[leaf] = torch.nn.Parameter(x, requires_grad=False)
    return params


def _mm_cache(cfg, batch: int, length: int, rows, chunks, n_chunks: int, dev) -> dict:
    """A random cache from seed: layer l's slots of chunk j of ``n_chunks``
    drawn from a generator of their own, so that a rank holding chunk j of
    rows ``rows`` holds the one-card cache's values there."""
    import torch
    from repro_torch.models import transformer

    shapes = transformer.init_cache(cfg, batch, length, device="meta")
    sc = length // n_chunks
    out = {}
    for si, (seg, leaves) in enumerate(shapes.items()):
        out[seg] = {}
        for li, (leaf, meta) in enumerate(leaves.items()):
            L, _, _, *tail = meta.shape
            buf = torch.empty((L, len(rows), sc * len(chunks), *tail), dtype=meta.dtype,
                              device=dev)
            for layer in range(L):
                for k, j in enumerate(chunks):
                    g = torch.Generator(device=dev).manual_seed(
                        MM_SEED * 100003 + ((si * 8 + li) * 1024 + layer) * 64 + j)
                    x = torch.randn((batch, sc, *tail), generator=g, device=dev)
                    buf[layer, :, k * sc:(k + 1) * sc] = x[rows].to(meta.dtype)
            out[seg][leaf] = buf
    return out


def _rel_l2(got, want) -> float:
    import torch

    got, want = torch.as_tensor(got).double(), torch.as_tensor(want).double()
    return float(torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want))


def _mm_peak(dev) -> int:
    import torch

    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0


def _mm_reset(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)


def _mm_sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class _TopiLog:
    """While open, every MoE call of the LM records the top-k experts of
    its tokens and the gap between the k-th and the (k+1)-th router
    probability (measurement only: one more routing product a call)."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        import torch
        from repro_torch.models import moe, transformer
        from repro_torch.models.layers import dot_f32

        self._orig = {n: getattr(transformer, n) for n in ("moe_ffn", "moe_ffn_decode_ep_all")}

        def wrap(fn):
            def logged(params, x2d, cfg, *a, **kw):
                probs = torch.softmax(dot_f32(x2d, params["router"]), dim=-1)
                top = torch.topk(probs, cfg.top_k + 1, dim=-1).values
                self.calls.append(dict(topi=moe._route(params["router"], x2d, cfg)[1].cpu(),
                                       gap=((top[:, -2] - top[:, -1]) / top[:, -2]).cpu()))
                return fn(params, x2d, cfg, *a, **kw)
            return logged

        for n, f in self._orig.items():
            setattr(transformer, n, wrap(f))
        return self

    def __exit__(self, *exc):
        from repro_torch.models import transformer

        for n, f in self._orig.items():
            setattr(transformer, n, f)


def _mm_topi_compare(got_calls, want_calls) -> dict:
    """Tokens whose top-k experts differ, and whether each lies within
    ``MM_TOL["topi_gap"]`` of a tie on the one-card path."""
    import torch

    diff = near = total = 0
    for g, w in zip(got_calls, want_calls):
        bad = (torch.sort(g["topi"], -1).values != torch.sort(w["topi"], -1).values).any(-1)
        diff += int(bad.sum())
        near += int((bad & (w["gap"] <= MM_TOL["topi_gap"])).sum())
        total += int(bad.numel())
    return dict(tokens=total, differ=diff, differ_near_tie=near,
                calls=(len(got_calls), len(want_calls)))


# ---- the one-card comparators (the parent, before each group)


def mm_ref_decode(dev, plan, case: str) -> dict:
    """The one-card comparators of a decode case, over the seeded cache:
    the same variant's step on a one-process mesh (``LocalMesh``: the
    split-KV algorithm on the card, no sharding), and the batch decode
    (another algorithm: its attention weights are rounded to bfloat16
    before the weighted sum, the split path's are not). For ``mla`` also
    the baseline prefill chunk, on a ``LocalMesh`` and plain."""
    from repro_torch.distributed.sharding import LocalMesh, ShardCtx

    p = plan[case]
    arch, cfg = _mm_cfg(plan, case)
    _mm_reset(dev)
    params = mm_init(arch, cfg, dev)
    n = p["mesh"][1]
    cache = _mm_cache(cfg, p["batch"], p["cache"], list(range(p["batch"])), list(range(n)),
                      n, dev)
    span = slice(p["pos"], p["pos"] + p["steps"])
    kept = {s: {k: v[:, :, span].clone() for k, v in leaves.items()}
            for s, leaves in cache.items()}
    local = ShardCtx(LocalMesh())
    res = {}
    for label, ctx, variant in (("same", local, "split_kv"), ("batch", None, "baseline")):
        decode, _ = arch.build_step(cfg, "decode_32k", ctx, variant=variant)
        row = dict(logits=[], ms=[])
        with _TopiLog() as topi:
            for i in range(p["steps"]):
                batch = dict(tokens=_mm_tokens(cfg, p["batch"], 1, 10 + i), cache=cache,
                             pos=p["pos"] + i)
                t0 = time.perf_counter()
                logits, cache = decode(params, batch)
                _mm_sync(dev)
                row["ms"].append((time.perf_counter() - t0) * 1e3)
                row["logits"].append(logits.float().cpu())
        row["topi"] = topi.calls
        res[label] = row
        for s, leaves in kept.items():  # the slots the steps wrote, as they were
            for k, v in leaves.items():
                cache[s][k][:, :, span] = v
    if case == "mla":
        toks = _mm_tokens(cfg, p["batch"], p["chunk"], 20)
        for label, ctx in (("same", local), ("batch", None)):
            prefill, _ = arch.build_step(cfg, "prefill_32k", ctx)
            with _TopiLog() as topi:
                t0 = time.perf_counter()
                logits, _ = prefill(params, {"tokens": toks})
                _mm_sync(dev)
            res[label]["prefill"] = dict(logits=logits.float().cpu(), topi=topi.calls,
                                         ms=(time.perf_counter() - t0) * 1e3)
    res["peak"] = _mm_peak(dev)
    del params, cache
    res["f32"] = mm_ref_f32(dev, plan, case)
    return res


def mm_ref_f32(dev, plan, case: str):
    """The float32 shallow cut's split-KV step on a one-process mesh, over
    the seeded cache: its logits on the host. Only the sharding separates
    the mesh's step from it, and in float32 that is the order of sums."""
    from repro_torch.distributed.sharding import LocalMesh, ShardCtx

    p = plan[case]
    arch, cfg = _mm_cfg(plan, case, f32=True)
    _mm_reset(dev)
    params = mm_init(arch, cfg, dev)
    n = p["mesh"][1]
    cache = _mm_cache(cfg, p["batch"], p["cache"], list(range(p["batch"])), list(range(n)),
                      n, dev)
    decode, _ = arch.build_step(cfg, "decode_32k", ShardCtx(LocalMesh()), variant="split_kv")
    logits, _ = decode(params, dict(tokens=_mm_tokens(cfg, p["batch"], 1, 10), cache=cache,
                                    pos=p["pos"]))
    out = logits.float().cpu()
    del params, cache, logits
    _mm_reset(dev)
    return out


def mm_ref_train(dev, plan) -> dict:
    """The one-card train step on the same global batches, four steps (the
    fourth the uninterrupted run's step after the save), the compared
    leaves at the start too; then the same steps with a planted fault:
    data rank 1 of the mesh never updating its ZeRO-1 part."""
    import torch
    from repro_torch.models.layers import param_leaves
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state

    p = plan["train"]
    arch, cfg = _mm_cfg(plan, "train")
    _mm_reset(dev)
    params = mm_init(arch, cfg, dev)
    state = init_opt_state(params, AdamWConfig(moment_dtype=arch.moment_dtype(cfg)))
    step, _ = arch.build_step(cfg, "train_4k")
    res = dict(loss=[], ms=[], leaves={0: _mm_train_leaves(param_leaves(params))})
    for i in range(p["steps"] + 1):
        rows = p["batch"] if i < p["steps"] else p["after_batch"]
        t0 = time.perf_counter()
        params, state, m = step(params, state, {"tokens": _mm_tokens(cfg, rows, p["seq"],
                                                                     30 + i)})
        _mm_sync(dev)
        res["ms"].append((time.perf_counter() - t0) * 1e3)
        res["loss"].append(float(m["loss"]))
        if i >= p["steps"] - 1:
            res["leaves"][i + 1] = _mm_train_leaves(param_leaves(params))
    res["peak"] = _mm_peak(dev)
    del params, state
    _mm_reset(dev)
    parts = _mm_zero1_part(arch, cfg, p["mesh"], 1)
    params = mm_init(arch, cfg, dev)
    state = init_opt_state(params, AdamWConfig(moment_dtype=arch.moment_dtype(cfg)))
    fault = dict(loss=[])
    for i in range(p["steps"]):
        leaves = param_leaves(params)
        kept = {n: leaves[n][sl].clone() for n, sl in parts.items()}
        params, state, m = step(params, state, {"tokens": _mm_tokens(cfg, p["batch"], p["seq"],
                                                                     30 + i)})
        with torch.no_grad():
            for n, sl in parts.items():
                leaves[n][sl] = kept[n]
        fault["loss"].append(float(m["loss"]))
        del kept
    fault["leaves"] = _mm_train_leaves(param_leaves(params))
    res["fault"] = fault
    del params, state
    _mm_reset(dev)
    return res


def _mm_zero1_part(arch, cfg, mesh_shape, data_rank: int) -> dict:
    """{parameter name: index} of the part that ``data_rank`` updates under
    ZeRO-1 on a (data, model) mesh of ``mesh_shape``, by the reference's
    ``zero1_state_specs``: a slice of the dim it shards over ``data``, or a
    stacked segment's whole layer."""
    from repro_torch.distributed.sharding import spec_at
    from repro_torch.models.layers import _ref_key, param_leaves
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state
    from repro_torch.train import trainer

    shapes = arch.param_shapes(cfg)
    nd = mesh_shape[0]
    o = trainer.zero1_state_specs(arch.param_pspecs(cfg, None), shapes,
                                  init_opt_state(shapes, AdamWConfig()), nd, ("data",),
                                  dict(zip(("data", "model"), mesh_shape)))
    out = {}
    for name, meta in param_leaves(shapes).items():
        path, layer = _ref_key(name, shapes.stacked)
        spec = tuple(spec_at(o["m"], path))
        j = next((i for i, e in enumerate(spec) if e == "data"), None)
        if j is None:
            continue
        if layer is not None:
            if j == 0:
                if layer // (len(shapes[path[0]]) // nd) == data_rank:
                    out[name] = (slice(None),)
                continue
            j -= 1
        w = meta.shape[j] // nd
        out[name] = (*(slice(None),) * j, slice(data_rank * w, (data_rank + 1) * w))
    return out


def mm_ref_gnn(dev, plan, graph) -> dict:
    """GraphSAGE's one-card baseline step on the published graph,
    and the sharded variant's inputs written for the ranks."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import ARCHS
    from repro_torch.models import gnn
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state

    p = plan["gnn"]
    arch = ARCHS["graphsage-reddit"]
    cfg = arch.model_config(not plan["full"])
    rcfg = arch._resolved(cfg, p["shape"])
    _mm_reset(dev)
    params = arch.init_params(MM_SEED, rcfg, device=dev)
    state = init_opt_state(params, AdamWConfig())
    step, _ = arch.build_step(cfg, p["shape"])
    batch = {k: torch.from_numpy(np.array(v)).to(dev) for k, v in graph.items()}
    res = dict(loss=[], ms=[])
    for _ in range(p["steps"]):
        t0 = time.perf_counter()
        params, state, m = step(params, state, batch)
        _mm_sync(dev)
        res["ms"].append((time.perf_counter() - t0) * 1e3)
        res["loss"].append(float(m["loss"]))
    res["params"] = {n: t.float().cpu() for n, t in params.named_parameters()}
    res["peak"] = _mm_peak(dev)
    del params, state
    spec = arch.input_specs(cfg, p["shape"], "sharded")
    t0 = time.perf_counter()
    sharded = gnn.shard_graph(batch["feats"], batch["edges"], batch["labels"],
                              p["mesh"][0], spec["feats"].shape[0], spec["edges"].shape[0],
                              dev)
    del batch
    paths = {}
    for k, v in sharded.items():
        paths[k] = str(MESH_DIR / f"gnn_{k}.npy")
        np.save(paths[k], v.cpu().numpy())
    res["shard_s"] = time.perf_counter() - t0
    res["paths"] = paths
    del sharded
    _mm_reset(dev)
    return res


def mm_ref_towers(dev, plan) -> dict:
    """Each tower's one-card serve scores and training loss."""
    import torch
    from repro_torch.configs.registry import ARCHS
    from repro_torch.models import recsys

    p = plan["towers"]
    res = {}
    for name, rows in p["train"].items():
        arch = ARCHS[name]
        cfg = arch.model_config(not plan["full"])
        _mm_reset(dev)
        params = mm_init(arch, cfg, dev)
        serve, _ = arch.build_step(cfg, p["serve"])
        sb = arch.make_batch(cfg, p["serve"], seed=MM_SEED)
        tb = {k: v[:rows] for k, v in arch.make_batch(cfg, "train_batch",
                                                      seed=MM_SEED).items()}
        with torch.no_grad():
            t0 = time.perf_counter()
            scores = serve(params, sb)
            _mm_sync(dev)
            serve_ms = (time.perf_counter() - t0) * 1e3
            loss = float(recsys.rec_train_loss(params, tb, cfg))
        res[name] = dict(scores=scores.float().cpu(), loss=loss, serve_ms=serve_ms,
                         rows=rows, peak=_mm_peak(dev))
        del params, scores
    _mm_reset(dev)
    return res


def mm_ref_pod(dev, plan) -> dict:
    """The mean of the two pods' float32 gradients of a linear model."""
    import torch

    p = plan["pod"]
    w, batch = _mm_pod_inputs(p, dev)

    def grad(rows):
        wg = w.clone().requires_grad_(True)
        loss = torch.mean((rows @ wg - 1.0) ** 2)
        return torch.autograd.grad(loss, wg)[0]

    half = p["rows"] // 2
    return dict(mean=((grad(batch[:half]) + grad(batch[half:])) / 2).cpu())


def _mm_pod_inputs(p, dev):
    import torch

    g = torch.Generator(device=dev).manual_seed(MM_SEED)
    return (torch.randn(p["n"], generator=g, device=dev) / p["n"] ** 0.5,
            torch.randn((p["rows"], p["n"]), generator=g, device=dev))


# ---- the ranks


def _mm_log(rt, msg: str) -> None:
    if rt.rank == 0:
        log(f"mesh_model {msg}")


def _mm_gloo_rate(rt, mb: int = 256) -> dict:
    """GB/s of one host-staged gloo all_reduce of ``mb`` MB of bfloat16 on
    the group (what a large collective costs ranks that share a card)."""
    import torch
    from repro_torch.distributed import sharding as ms

    mesh = ms.make_mesh((rt.world,), ("all",))
    x = torch.ones(mb * 2**19, dtype=torch.bfloat16, device=rt.device)
    with ms.bound(mesh):
        ms.psum(x[:1024], "all")
        _mm_sync(rt.device)
        t0 = time.perf_counter()
        ms.psum(x, "all")
        _mm_sync(rt.device)
        s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ms.all_gather(x[: x.numel() // rt.world], "all")
        _mm_sync(rt.device)
        g = time.perf_counter() - t0
    return dict(mb=mb, s=s, gb_per_s=mb * 2**20 / s / 1e9, all_gather_s=g)


class _CommTimer:
    """While open, the host seconds and bytes of this rank's mesh
    collectives (``sharding``'s all_reduce, all_gather and root gather),
    each timed from its call to its return (host staging included)."""

    def __enter__(self):
        from repro_torch.distributed import sharding as ms

        self.s, self.bytes, self.calls, self.kinds = 0.0, 0, 0, {}
        self._orig = {n: getattr(ms, n) for n in ("_all_reduce", "all_gather")}

        def wrap(fn, kind):
            def timed(x, *a, **kw):
                t0 = time.perf_counter()
                out = fn(x, *a, **kw)
                s = time.perf_counter() - t0
                b = x.numel() * x.element_size()
                self.s, self.bytes, self.calls = self.s + s, self.bytes + b, self.calls + 1
                k = self.kinds.setdefault(kind, [0, 0.0, 0])
                k[0], k[1], k[2] = k[0] + 1, k[1] + s, k[2] + b
                return out
            return timed

        for n, f in self._orig.items():
            setattr(ms, n, wrap(f, n.strip("_")))
        return self

    def __exit__(self, *exc):
        from repro_torch.distributed import sharding as ms

        for n, f in self._orig.items():
            setattr(ms, n, f)

    def row(self) -> dict:
        return dict(comm_s=self.s, comm_bytes=self.bytes, comm_calls=self.calls,
                    comm_by_kind=self.kinds)


def _mm_ranks(rt, fn) -> list:
    """``fn()`` on every rank; every rank's result, in rank order."""
    import torch.distributed as dist

    out = [None] * rt.world
    dist.all_gather_object(out, fn(), group=rt.control)
    return out


def _mm_params(rt, arch, cfg, specs, mesh):
    """This rank's blocks of the seed's parameters (``mm_init``)."""
    return mm_init(arch, cfg, rt.device, specs, mesh)


def _mm_bytes(tree) -> int:
    import torch

    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(_mm_bytes(v) for v in tree.values())
    return sum(p.numel() * p.element_size() for p in tree.parameters())


def _mm_decode_rank(rt, plan, case: str) -> dict:
    from repro_torch.distributed import sharding as ms

    p = plan[case]
    arch, cfg = _mm_cfg(plan, case)
    mesh = ms.make_mesh(p["mesh"], ("data", "model"))
    ctx = ms.ShardCtx(mesh)
    dr, nd = ms.mesh_coord(mesh, "data")
    m, nm = ms.mesh_coord(mesh, "model")
    _mm_reset(rt.device)
    t0 = time.perf_counter()
    specs = arch.param_pspecs(cfg, None, variant="split_kv", ctx=ctx)
    params = _mm_params(rt, arch, cfg, specs, mesh)
    bl = p["batch"] // nd
    cache = _mm_cache(cfg, p["batch"], p["cache"], list(range(dr * bl, (dr + 1) * bl)), [m],
                      nm, rt.device)
    load_s = time.perf_counter() - t0
    decode, _ = arch.build_step(cfg, "decode_32k", ctx, variant="split_kv")
    res = dict(logits=[], ms=[], param_bytes=_mm_bytes(params), cache_bytes=_mm_bytes(cache),
               load_s=load_s)
    with _TopiLog() as topi:
        for i in range(p["steps"]):
            toks = ms.place(_mm_tokens(cfg, p["batch"], 1, 10 + i), ms.P("data", None), mesh)
            t0 = time.perf_counter()
            logits, cache = decode(params, dict(tokens=toks, cache=cache, pos=p["pos"] + i))
            _mm_sync(rt.device)
            res["ms"].append((time.perf_counter() - t0) * 1e3)
            res["logits"].append(ms.gather(logits.float(), decode.out_specs[0], mesh, root=0))
    res["topi"] = topi.calls
    if case == "mla":
        # A planted fault: the experts of rank 1 dropped (its block of the
        # routed experts' w_down zeroed), step 1 again.
        if rt.rank == 1:
            for n, w in params.named_parameters():
                if n.endswith("moe.w_down"):
                    w.data.zero_()
        toks = ms.place(_mm_tokens(cfg, p["batch"], 1, 10), ms.P("data", None), mesh)
        logits, cache = decode(params, dict(tokens=toks, cache=cache, pos=p["pos"]))
        res["experts_dropped"] = ms.gather(logits.float(), decode.out_specs[0], mesh, root=0)
    del params, cache
    res["f32"] = _mm_f32_rank(rt, plan, case, mesh, ctx)
    if case == "mla":
        _mm_reset(rt.device)
        specs = arch.param_pspecs(cfg, None, variant="baseline", ctx=ctx)
        params = _mm_params(rt, arch, cfg, specs, mesh)
        prefill, _ = arch.build_step(cfg, "prefill_32k", ctx)
        toks = ms.place(_mm_tokens(cfg, p["batch"], p["chunk"], 20), ms.P("data", None), mesh)
        with _TopiLog() as topi:
            t0 = time.perf_counter()
            logits, _ = prefill(params, {"tokens": toks})
            _mm_sync(rt.device)
        res["prefill"] = dict(logits=ms.gather(logits.float(), prefill.out_specs[0], mesh,
                                               root=0),
                              topi=topi.calls, ms=(time.perf_counter() - t0) * 1e3,
                              param_bytes=_mm_bytes(params))
        del params
    res["peak"] = _mm_peak(rt.device)
    _mm_reset(rt.device)
    return res


def _mm_f32_rank(rt, plan, case: str, mesh, ctx) -> dict:
    """The float32 shallow cut's split-KV step on the mesh (rank 0 gets the
    logits): sound, then with a planted fault, model rank 0 holding the
    slots of the next rank's chunk in place of its own (a KV slice in the
    wrong place; rank 0's slots all lie before the step's position)."""
    from repro_torch.distributed import sharding as ms

    p = plan[case]
    arch, cfg = _mm_cfg(plan, case, f32=True)
    dr, nd = ms.mesh_coord(mesh, "data")
    m, nm = ms.mesh_coord(mesh, "model")
    _mm_reset(rt.device)
    specs = arch.param_pspecs(cfg, None, variant="split_kv", ctx=ctx)
    params = _mm_params(rt, arch, cfg, specs, mesh)
    decode, _ = arch.build_step(cfg, "decode_32k", ctx, variant="split_kv")
    bl = p["batch"] // nd
    out = {}
    for label, chunk in (("sound", m), ("fault", (m + 1) % nm if m == 0 else m)):
        cache = _mm_cache(cfg, p["batch"], p["cache"], list(range(dr * bl, (dr + 1) * bl)),
                          [chunk], nm, rt.device)
        toks = ms.place(_mm_tokens(cfg, p["batch"], 1, 10), ms.P("data", None), mesh)
        logits, cache = decode(params, dict(tokens=toks, cache=cache, pos=p["pos"]))
        out[label] = ms.gather(logits.float(), decode.out_specs[0], mesh, root=0)
        del cache, logits
    del params
    _mm_reset(rt.device)
    return out


def _mm_train_rank(rt, plan) -> dict:
    """Three ZeRO-1 steps on the 2 x 2 mesh, the state saved (gathered on
    rank 0), restored with ``shardings`` onto 4 x 1, one more step."""
    import shutil

    import torch
    import torch.distributed as dist
    from repro_torch.distributed import sharding as ms
    from repro_torch.models.layers import param_leaves, params_from_tree
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state
    from repro_torch.train import trainer
    from repro_torch.train.checkpoint import Checkpointer

    p = plan["train"]
    arch, cfg = _mm_cfg(plan, "train")
    opt = AdamWConfig(moment_dtype=arch.moment_dtype(cfg))
    mesh = ms.make_mesh(p["mesh"], ("data", "model"))
    ctx = ms.ShardCtx(mesh)
    specs = arch.param_pspecs(cfg, None)
    _mm_reset(rt.device)
    params = _mm_params(rt, arch, cfg, specs, mesh)
    state = trainer.init_zero1_state(params, opt, specs, ctx)
    res = dict(loss=[], ms=[], param_bytes=_mm_bytes(params),
               moment_bytes=_mm_bytes(state["m"]) + _mm_bytes(state["v"]))
    step, _ = arch.build_step(cfg, "train_4k", ctx)
    bspec = arch.batch_pspecs(cfg, "train_4k", ctx)
    for i in range(p["steps"]):
        batch = ms.place_tree({"tokens": _mm_tokens(cfg, p["batch"], p["seq"], 30 + i)}, bspec,
                              mesh)
        t0 = time.perf_counter()
        params, state, m = step(params, state, batch)
        _mm_sync(rt.device)
        res["ms"].append((time.perf_counter() - t0) * 1e3)
        res["loss"].append(float(m["loss"]))
        _mm_log(rt, f"train step {i + 1}: {res['ms'][-1]:.0f} ms")
    res["peak"] = _mm_peak(rt.device)
    # Save: the state gathered on rank 0's host, leaf by leaf.
    t0 = time.perf_counter()
    gp = ms.gather_tree(params, specs, mesh, root=0)
    go = trainer.gather_opt_state(state, params, specs, ctx, opt.moment_dtype, root=0)
    directory = MESH_DIR / "train_ckpt"
    ck = Checkpointer(str(directory))
    saved = None
    if rt.rank == 0:
        res["leaves"] = {p["steps"]: _mm_train_leaves(param_leaves(gp))}
        saved = {"params": arch.params_to_numpy(gp), "opt_state": arch.opt_state_to_numpy(go)}
        need = sum(a.nbytes for a in _mm_leaves(saved))
        check(shutil.disk_usage(MESH_DIR).free > 1.1 * need,
              f"mesh_model train: {need} B of state, {shutil.disk_usage(MESH_DIR).free} B "
              "free on disk")
        ck.save(saved, step=p["steps"], blocking=True)
        res["state_bytes"] = need
    del gp, go, params, state
    _mm_reset(rt.device)
    dist.barrier(group=rt.control)
    res["save_s"] = time.perf_counter() - t0
    _mm_log(rt, f"train save {res['save_s']:.1f} s")
    # Restore onto 4 x 1 and take the fourth step there.
    t0 = time.perf_counter()
    mesh4 = ms.make_mesh(p["restore_mesh"], ("data", "model"))
    ctx4 = ms.ShardCtx(mesh4)
    shapes = arch.param_shapes(cfg)
    o_specs = trainer.zero1_state_specs(specs, shapes, init_opt_state(shapes, opt),
                                        ctx4.n_data, ctx4.data_axes,
                                        dict(zip(mesh4.mesh_dim_names, p["restore_mesh"])))
    named = _mm_named(ms, {"params": specs, "opt_state": o_specs}, mesh4)
    tree = ck.restore(p["steps"], shardings=named)
    params = params_from_tree(tree["params"], rt.device, stacked=arch.stacked)
    state = trainer.opt_state_from_tree(tree["opt_state"], arch.stacked, rt.device,
                                        specs=o_specs, mesh=mesh4)
    del tree
    res["restore_s"] = time.perf_counter() - t0
    _mm_log(rt, f"train restore {res['restore_s']:.1f} s")
    back = ms.gather_tree(params, specs, mesh4, root=0)
    if rt.rank == 0:
        want = _mm_leaves(saved["params"])
        got = _mm_leaves(arch.params_to_numpy(back))
        res["restore_exact"] = len(got) == len(want) and all(
            a.dtype == b.dtype and a.tobytes() == b.tobytes() for a, b in zip(got, want))
    del back, saved
    step4, _ = arch.build_step(cfg, "train_4k", ctx4)
    batch = ms.place_tree({"tokens": _mm_tokens(cfg, p["after_batch"], p["seq"],
                                                30 + p["steps"])},
                          arch.batch_pspecs(cfg, "train_4k", ctx4), mesh4)
    t0 = time.perf_counter()
    params, state, m = step4(params, state, batch)
    _mm_sync(rt.device)
    res["after"] = dict(loss=float(m["loss"]), ms=(time.perf_counter() - t0) * 1e3,
                        param_bytes=_mm_bytes(params),
                        moment_bytes=_mm_bytes(state["m"]) + _mm_bytes(state["v"]))
    leaves = ms.gather_tree(params, specs, mesh4, root=0)
    if leaves is not None:
        res["leaves"][p["steps"] + 1] = _mm_train_leaves(param_leaves(leaves))
    del params, state, leaves
    # Each step's own peak (the stats were reset before the restore): the
    # dry run's (ii) holds each against its own prediction.
    res["step_peaks"] = [res["peak"], _mm_peak(rt.device)]
    res["peak"] = max(res["step_peaks"])
    _mm_reset(rt.device)
    if rt.rank == 0:
        shutil.rmtree(directory, ignore_errors=True)
    return res


def _mm_named(ms, specs, mesh):
    if isinstance(specs, ms.P):
        return ms.NamedSharding(mesh, specs)
    if isinstance(specs, dict):
        return {k: _mm_named(ms, v, mesh) for k, v in specs.items()}
    return [_mm_named(ms, v, mesh) for v in specs]


def _mm_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [a for k in sorted(tree) for a in _mm_leaves(tree[k])]
    if isinstance(tree, list):
        return [a for v in tree for a in _mm_leaves(v)]
    return [tree]


def _mm_gnn_rank(rt, plan, paths) -> dict:
    import numpy as np
    from repro_torch.configs.registry import ARCHS
    from repro_torch.distributed import sharding as ms
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train import trainer

    p = plan["gnn"]
    arch = ARCHS["graphsage-reddit"]
    cfg = arch.model_config(not plan["full"])
    rcfg = arch._resolved(cfg, p["shape"])
    mesh = ms.make_mesh(p["mesh"], ("data", "model"))
    ctx = ms.ShardCtx(mesh)
    specs = arch.param_pspecs(rcfg, None)
    _mm_reset(rt.device)
    t0 = time.perf_counter()
    params = ms.place_tree(arch.init_params(MM_SEED, rcfg, device=rt.device), specs, mesh)
    state = trainer.init_zero1_state(params, AdamWConfig(), specs, ctx)
    bspec = arch.batch_pspecs(cfg, p["shape"], ctx, "sharded")
    batch = {k: ms.place(np.load(path, mmap_mode="r"), bspec[k], mesh)
             for k, path in paths.items()}
    res = dict(loss=[], ms=[], load_s=time.perf_counter() - t0,
               nodes=int(batch["feats"].shape[0]),
               edges=int((batch["edges"][:, 0] >= 0).sum()))
    step, _ = arch.build_step(cfg, p["shape"], ctx, variant="sharded")
    for _ in range(p["steps"]):
        t0 = time.perf_counter()
        params, state, m = step(params, state, batch)
        _mm_sync(rt.device)
        res["ms"].append((time.perf_counter() - t0) * 1e3)
        res["loss"].append(float(m["loss"]))
        _mm_log(rt, f"gnn step: {res['ms'][-1]:.0f} ms (load {res['load_s']:.1f} s)")
    res["params"] = {n: t.float().cpu() for n, t in params.named_parameters()}
    res["peak"] = _mm_peak(rt.device)
    del params, state, batch
    _mm_reset(rt.device)
    return res


def _mm_towers_rank(rt, plan) -> dict:
    import torch
    from repro_torch.configs.registry import ARCHS
    from repro_torch.distributed import sharding as ms
    from repro_torch.models import recsys

    p = plan["towers"]
    mesh = ms.make_mesh(p["mesh"], ("data", "model"))
    ctx = ms.ShardCtx(mesh)
    res = {}
    for name, rows in p["train"].items():
        arch = ARCHS[name]
        cfg = arch.model_config(not plan["full"])
        _mm_reset(rt.device)
        specs = arch.param_pspecs(cfg, arch.param_shapes(cfg))
        params = _mm_params(rt, arch, cfg, specs, mesh)
        serve, _ = arch.build_step(cfg, p["serve"], ctx)
        sb = ms.place_tree(arch.make_batch(cfg, p["serve"], seed=MM_SEED),
                           arch.batch_pspecs(cfg, p["serve"], ctx), mesh)
        tb = ms.place_tree({k: v[:rows] for k, v in arch.make_batch(
            cfg, "train_batch", seed=MM_SEED).items()},
            arch.batch_pspecs(cfg, "train_batch", ctx), mesh)
        with torch.no_grad():
            t0 = time.perf_counter()
            scores = serve(params, sb)
            _mm_sync(rt.device)
            serve_ms = (time.perf_counter() - t0) * 1e3
            loss = float(recsys.rec_train_loss(params, tb, cfg, ctx))
        res[name] = dict(scores=ms.gather(scores.float(), serve.out_specs, mesh, root=0),
                         loss=loss, serve_ms=serve_ms, param_bytes=_mm_bytes(params),
                         peak=_mm_peak(rt.device))
        del params, scores
    _mm_reset(rt.device)
    return res


def _mm_pod_rank(rt, plan) -> dict:
    import torch
    from repro_torch.distributed import sharding as ms
    from repro_torch.optim.compression import compress_psum_pod

    p = plan["pod"]
    mesh = ms.make_mesh(p["mesh"], ("pod", "data"))
    w, batch = _mm_pod_inputs(p, rt.device)

    def grad_fn(rows):
        with torch.enable_grad():
            wg = w.clone().requires_grad_(True)
            return {"w": torch.autograd.grad(torch.mean((rows @ wg - 1.0) ** 2), wg)[0]}

    err = {"w": torch.zeros((p["mesh"][0], p["n"]), device=rt.device)}
    t0 = time.perf_counter()
    grads, new_err = compress_psum_pod(grad_fn, mesh)(batch, err)
    _mm_sync(rt.device)
    return dict(grads=grads["w"].cpu(), err_shape=tuple(new_err["w"].shape),
                err_max=float(new_err["w"].abs().max()), ms=(time.perf_counter() - t0) * 1e3)


def mesh_case_model1(rt, job, out) -> list:
    """(a) split-KV decode on 1 x 4, (c) the sharded train step and the
    elastic restore, (d) sharded GraphSAGE on 4 x 1, (e) the towers on
    1 x 4, in turn on one group of four ranks."""
    plan = job["plan"]
    walls = {}
    out["gloo"] = _mm_gloo_rate(rt)
    _mm_log(rt, f"gloo all_reduce of {out['gloo']['mb']} MB bfloat16 over {rt.world} ranks "
                f"on one card: {out['gloo']['s']:.2f} s = {out['gloo']['gb_per_s']:.2f} GB/s; "
                f"all_gather of {out['gloo']['mb'] // rt.world} MB a rank: "
                f"{out['gloo']['all_gather_s']:.2f} s")
    for key, fn in (("decode", lambda: _mm_decode_rank(rt, plan, "decode")),
                    ("train", lambda: _mm_train_rank(rt, plan)),
                    ("gnn", lambda: _mm_gnn_rank(rt, plan, job["gnn_paths"])),
                    ("towers", lambda: _mm_towers_rank(rt, plan))):
        t0 = time.perf_counter()
        with _CommTimer() as comm:
            res = fn()
        res.update(comm.row())
        out[key] = _mm_ranks(rt, lambda: res)
        walls[key] = time.perf_counter() - t0
        if rt.rank == 0:
            log(f"mesh_model {key}: {walls[key]:.1f} s on the ranks, of which "
                f"{res['comm_s']:.1f} s in {res['comm_calls']} collectives "
                f"({res['comm_bytes'] / 1e9:.2f} GB sent by rank 0; by kind "
                + ", ".join(f"{k} {v[0]} calls {v[1]:.1f} s {v[2] / 1e9:.2f} GB"
                            for k, v in res["comm_by_kind"].items()) + ")")
    out["walls"] = walls
    return [_mm_launches()]


def _mm_launches() -> int:
    """Launches of the five kernels' wrappers on this rank (none of these
    paths runs one)."""
    from repro_torch.kernels.embedding_bag import kernel as bag

    return sum(read_launches().values()) + bag.bag_reduce.launches


def mesh_case_model2(rt, job, out) -> list:
    """(b) deepseek-v3's split-KV decode and a prefill chunk on 2 x 2, (f)
    the pod exchange on 2 x 2 (pod x data)."""
    plan = job["plan"]
    walls = {}
    for key, fn in (("mla", lambda: _mm_decode_rank(rt, plan, "mla")),
                    ("pod", lambda: _mm_pod_rank(rt, plan))):
        t0 = time.perf_counter()
        with _CommTimer() as comm:
            res = fn()
        res.update(comm.row())
        out[key] = _mm_ranks(rt, lambda: res)
        walls[key] = time.perf_counter() - t0
        if rt.rank == 0:
            log(f"mesh_model {key}: {walls[key]:.1f} s on the ranks, of which "
                f"{res['comm_s']:.1f} s in {res['comm_calls']} collectives "
                f"({res['comm_bytes'] / 1e9:.2f} GB sent by rank 0; by kind "
                + ", ".join(f"{k} {v[0]} calls {v[1]:.1f} s {v[2] / 1e9:.2f} GB"
                            for k, v in res["comm_by_kind"].items()) + ")")
    out["walls"] = walls
    return [_mm_launches()]


MESH_CASES.update(model1=mesh_case_model1, model2=mesh_case_model2)


def _mm_gib(b) -> str:
    return f"{b / 2**30:.2f}"


def mesh_model_phase(dev, pool, plan=MM_PLAN, device: str | None = None) -> dict:
    """The model and training paths over a mesh (ROADMAP A7) on ranks that
    share the card through host-staged gloo, so their times are not a
    figure for a node with four cards. Each one-card comparator runs first
    here, its results moved to the host and its memory freed; then one
    group of four ranks runs (a), (c), (d), (e) in turn and another (b) and
    (f). Every case is checked against its bound (``MM_TOL``); no kernel
    runs on these paths."""
    t_phase = time.perf_counter()
    MESH_DIR.mkdir(parents=True, exist_ok=True)
    graph_job = pool.apply_async(build_gnn_batch_for, (str(SRC), plan["gnn"]["shape"],
                                                       plan["full"]))
    smi = nvidia_smi() if dev.type == "cuda" else "cpu"
    res = dict(card=smi, plan={k: v for k, v in plan.items()})
    t0 = time.perf_counter()
    ref = {}
    for key, fn in (("decode", lambda: mm_ref_decode(dev, plan, "decode")),
                    ("train", lambda: mm_ref_train(dev, plan)),
                    ("towers", lambda: mm_ref_towers(dev, plan))):
        t1 = time.perf_counter()
        ref[key] = fn()
        log(f"mesh_model one-card {key}: {time.perf_counter() - t1:.1f} s")
    graph = graph_job.get()
    import numpy as np

    ref["gnn"] = mm_ref_gnn(dev, plan, {k: np.load(p, mmap_mode="r")
                                        for k, p in graph["paths"].items()})
    ref["gnn"]["build_s"] = graph["build_s"]
    for p in graph["paths"].values():
        Path(p).unlink(missing_ok=True)
    res["ref1_s"] = time.perf_counter() - t0
    got1 = spawn_mesh("model1", MM_GROUP, dict(plan=plan, gnn_paths=ref["gnn"]["paths"]),
                      device=device)
    t0 = time.perf_counter()
    ref["mla"] = mm_ref_decode(dev, plan, "mla")
    ref["pod"] = mm_ref_pod(dev, plan)
    res["ref2_s"] = time.perf_counter() - t0
    got2 = spawn_mesh("model2", MM_GROUP, dict(plan=plan), device=device)
    for path in ref["gnn"]["paths"].values():
        Path(path).unlink(missing_ok=True)
    res["train_ranks"] = [dict(param_bytes=r["param_bytes"], moment_bytes=r["moment_bytes"],
                               peak=r["peak"], step_peaks=r["step_peaks"],
                               after={k: r["after"][k] for k in (
                                   "param_bytes", "moment_bytes")}) for r in got1["train"]]
    res["cases"] = cases = mm_checks(plan, ref, got1, got2)
    res["launches"] = sum(sum(r["launches"]) for g in (got1, got2) for r in g["ranks"])
    log(f"mesh_model launches of the five kernels on its ranks: {res['launches']} (no "
        "kernel runs on these paths)")
    check(res["launches"] == 0, f"mesh_model: {res['launches']} kernel launches")
    res["walls"] = dict(group1=got1["wall_s"], group2=got2["wall_s"], **got1["walls"],
                        **got2["walls"])
    res["wall_s"] = time.perf_counter() - t_phase
    failed = [k for k, c in cases.items() if not c["pass"]]
    log(f"mesh_model phase {res['wall_s']:.1f} s (comparators {res['ref1_s']:.1f} + "
        f"{res['ref2_s']:.1f} s, groups {got1['wall_s']:.1f} + {got2['wall_s']:.1f} s); card "
        f"{smi}; ranks share the card through host-staged gloo: no time here is a figure "
        f"for a node with four cards")
    check(not failed, f"mesh_model: cases {failed} failed")
    return res


def build_gnn_batch_for(src: str, shape: str, full: bool) -> dict:
    """Worker: GraphSAGE's ``make_batch`` at published (or reduced) size,
    written to ``MESH_DIR`` as ``.npy`` files (a 62M-edge graph would take
    longer through the pool's pipe); their paths."""
    import numpy as np

    sys.path.insert(0, src)
    from repro_torch.configs.registry import ARCHS

    arch = ARCHS["graphsage-reddit"]
    t0 = time.perf_counter()
    batch = arch.make_batch(arch.model_config(not full), shape, seed=MM_SEED)
    MESH_DIR.mkdir(parents=True, exist_ok=True)
    paths = {}
    for k, v in batch.items():
        paths[k] = str(MESH_DIR / f"graph_{k}.npy")
        np.save(paths[k], v)
    return dict(paths=paths, build_s=time.perf_counter() - t0)


def mm_checks(plan, ref, got1, got2) -> dict:
    """Every case's pass, largest relative error against its bound, per-rank
    peak memory and step times; logged, one line a case."""
    cases = {}

    def f32_check(key, got, want) -> str:
        """The float32 shallow cut's reading and its planted fault's: the
        sound one within ``MM_TOL["f32"]``, the fault beyond it."""
        sound, fault = _rel_l2(got["sound"], want), _rel_l2(got["fault"], want)
        ok = sound <= MM_TOL["f32"] < fault
        cases[key]["f32"] = dict(sound=sound, fault=fault, bound=MM_TOL["f32"], pass_=ok)
        cases[key]["pass"] = cases[key]["pass"] and ok
        log(f"mesh_model {key}: float32 shallow cut {'pass' if ok else 'FAIL'}: sound "
            f"{sound:.3g} <= {MM_TOL['f32']:g} < planted fault (a KV slice in the wrong "
            f"place) {fault:.3g}")
        return ok

    def row(key, errs, bound, ranks, ms, extra=""):
        worst = max(errs.values()) if errs else 0.0
        ok = worst <= bound and all(v == v for v in errs.values())
        peaks = [r.get("peak", 0) for r in ranks]
        cases[key] = {"pass": ok, "errors": errs, "bound": bound, "worst": worst,
                      "peak_bytes": peaks, "step_ms": ms}
        log(f"mesh_model {key}: {'pass' if ok else 'FAIL'}; largest relative error "
            f"{worst:.3g} against {bound:g} ({', '.join(f'{k} {v:.3g}' for k, v in errs.items())}"
            f"); per-rank peak {', '.join(_mm_gib(b) for b in peaks)} GiB; step wall "
            f"{', '.join(f'{t:.1f}' for t in ms)} ms{extra}")
        return ok

    d, r = got1["decode"], ref["decode"]
    same, base = r["same"], r["batch"]
    errs = {f"logits step {i + 1}": _rel_l2(d[0]["logits"][i], same["logits"][i])
            for i in range(len(same["logits"]))}
    gap = [(_rel_l2(d[0]["logits"][i], base["logits"][i]),
            _rel_l2(same["logits"][i], base["logits"][i])) for i in range(len(base["logits"]))]
    key = "(a) qwen3-4b split_kv decode_32k on 1 x 4"
    row(key, errs, MM_TOL["logits"], d, d[0]["ms"],
        f"; against the one-card batch decode (another algorithm) "
        f"{', '.join(f'{g:.4f}' for g, _ in gap)}, the one-card split-KV against it "
        f"{', '.join(f'{s:.4f}' for _, s in gap)}; one card split-KV "
        f"{', '.join(f'{t:.1f}' for t in same['ms'])}, batch "
        f"{', '.join(f'{t:.1f}' for t in base['ms'])} ms a step; per rank "
        f"{_mm_gib(d[0]['param_bytes'])} GiB of weights, {_mm_gib(d[0]['cache_bytes'])} GiB "
        f"of cache; one-card peak {_mm_gib(r['peak'])} GiB")
    cases[key]["against_batch"] = gap
    f32_check(key, d[0]["f32"], r["f32"])

    t, r = got1["train"], ref["train"]
    key = "(c) qwen3-4b train_4k ZeRO-1 on 2 x 2, restore onto 4 x 1"
    rel = lambda a, b: abs(a - b) / abs(b)  # noqa: E731
    errs = {f"loss step {i + 1}": rel(t[0]["loss"][i], r["loss"][i])
            for i in range(len(t[0]["loss"]))}
    errs[f"loss step {len(t[0]['loss']) + 1} (4 x 1)"] = rel(t[0]["after"]["loss"],
                                                             r["loss"][-1])
    init = r["leaves"][0]
    changes = {f"{n} change after step {s}": _mm_change_err(v, r["leaves"][s][n], init[n])
               for s, leaves in t[0]["leaves"].items() for n, v in leaves.items()}
    # The planted fault (data rank 1 never updating its ZeRO-1 part), on
    # the one-card path: the readings the gates must see beyond their bounds.
    f, s3 = r["fault"], plan["train"]["steps"]
    fault = dict(loss=max(rel(f["loss"][i], r["loss"][i]) for i in range(len(f["loss"]))),
                 changes={n: _mm_change_err(v, r["leaves"][s3][n], init[n])
                          for n, v in f["leaves"].items()})
    fault["change"] = max(fault["changes"].values())
    ok = row(key, errs, MM_TOL["train_loss"], t, t[0]["ms"] + [t[0]["after"]["ms"]],
             f"; one card {', '.join(f'{x:.1f}' for x in r['ms'])} ms a step; per rank "
             f"parameters {', '.join(_mm_gib(x['param_bytes']) for x in t)} GiB, moments "
             f"{', '.join(_mm_gib(x['moment_bytes']) for x in t)} GiB (on 4 x 1: "
             f"{', '.join(_mm_gib(x['after']['param_bytes']) for x in t)} and "
             f"{', '.join(_mm_gib(x['after']['moment_bytes']) for x in t)} GiB); state "
             f"{_mm_gib(t[0].get('state_bytes', 0))} GiB saved in {t[0]['save_s']:.1f} s, "
             f"restored in {t[0]['restore_s']:.1f} s, exact {t[0]['restore_exact']}")
    worst = max(changes.values())
    ok_change = worst <= MM_TOL["train_change"] and all(v == v for v in changes.values())
    ok_power = fault["loss"] > MM_TOL["train_loss"] and fault["change"] > MM_TOL["train_change"]
    log(f"mesh_model {key}: parameter changes since the start against the one card's "
        f"{'pass' if ok_change else 'FAIL'}; largest {worst:.3g} against "
        f"{MM_TOL['train_change']:g} ({', '.join(f'{k} {v:.3g}' for k, v in changes.items())}"
        f"); planted fault (data rank 1's ZeRO-1 part never updated, one card) "
        f"{'beyond' if ok_power else 'NOT beyond'} both bounds: loss {fault['loss']:.3g}, "
        f"change {fault['change']:.3g} ("
        + ", ".join(f"{n} {v:.3g}" for n, v in fault["changes"].items()) + ")")
    cases[key].update(changes=changes, fault=fault, change_bound=MM_TOL["train_change"])
    cases[key]["pass"] = ok and ok_change and ok_power and t[0]["restore_exact"]

    g, r = got1["gnn"], ref["gnn"]
    errs = {f"loss step {i + 1}": abs(g[0]["loss"][i] - r["loss"][i]) / abs(r["loss"][i])
            for i in range(len(r["loss"]))}
    for n, v in g[0]["params"].items():
        errs[n] = _rel_l2(v, r["params"][n])
    row("(d) graphsage ogb_products sharded on 4 x 1", errs, MM_TOL["loss"], g, g[0]["ms"],
        f"; one card {', '.join(f'{x:.1f}' for x in r['ms'])} ms a step, peak "
        f"{_mm_gib(r['peak'])} GiB; {g[0]['nodes']} nodes and {g[0]['edges']} edges a rank; "
        f"graph built in {r['build_s']:.1f} s, sharded in {r['shard_s']:.1f} s")

    w, r = got1["towers"], ref["towers"]
    errs = {}
    for name in r:
        errs[f"{name} serve"] = _rel_l2(w[0][name]["scores"], r[name]["scores"])
        errs[f"{name} loss"] = abs(w[0][name]["loss"] - r[name]["loss"]) / abs(r[name]["loss"])
    row("(e) the towers on 1 x 4 (row-sharded tables)", errs, MM_TOL["towers"],
        [dict(peak=max(x[n]["peak"] for n in r)) for x in w],
        [w[0][n]["serve_ms"] for n in r],
        "; serve ms by tower " + ", ".join(f"{n} {w[0][n]['serve_ms']:.1f} (one card "
                                           f"{r[n]['serve_ms']:.1f})" for n in r)
        + "; per rank table bytes " + ", ".join(f"{n} {_mm_gib(w[0][n]['param_bytes'])} GiB"
                                                for n in r))

    b, r = got2["mla"], ref["mla"]
    same, base = r["same"], r["batch"]
    errs = {f"logits step {i + 1}": _rel_l2(b[0]["logits"][i], same["logits"][i])
            for i in range(len(same["logits"]))}
    errs["prefill chunk logits"] = _rel_l2(b[0]["prefill"]["logits"],
                                           same["prefill"]["logits"])
    gap = [_rel_l2(b[0]["logits"][i], base["logits"][i]) for i in range(len(base["logits"]))]
    gap.append(_rel_l2(b[0]["prefill"]["logits"], base["prefill"]["logits"]))
    nm = plan["mla"]["mesh"][1]
    topi = dict(decode=_mm_topi_compare(_mm_concat_topi(b, nm, "decode"), same["topi"]),
                prefill=_mm_topi_compare(_mm_concat_topi(b, nm, "prefill"),
                                         same["prefill"]["topi"]))
    topi_batch = dict(
        decode=_mm_topi_compare(_mm_concat_topi(b, nm, "decode"), base["topi"]),
        prefill=_mm_topi_compare(_mm_concat_topi(b, nm, "prefill"), base["prefill"]["topi"]))
    key = "(b) deepseek-v3 split_kv decode and a baseline prefill chunk on 2 x 2"
    ok = row(key, errs, MM_TOL["logits"], b, b[0]["ms"] + [b[0]["prefill"]["ms"]],
             f"; one card {', '.join(f'{x:.1f}' for x in same['ms'])} ms a step (split-KV), "
             f"{', '.join(f'{x:.1f}' for x in base['ms'])} (batch), chunk "
             f"{same['prefill']['ms']:.1f} ms; topi: {topi}; against the one-card batch path "
             f"(another algorithm) logits {', '.join(f'{g:.4f}' for g in gap)}, topi "
             f"{topi_batch}; per rank weights {_mm_gib(b[0]['param_bytes'])} GiB (split) "
             f"and {_mm_gib(b[0]['prefill']['param_bytes'])} GiB (baseline)")
    cases[key].update(topi=topi, topi_batch=topi_batch, against_batch=gap)
    dropped = _rel_l2(b[0]["experts_dropped"], same["logits"][0])
    cases[key]["experts_dropped"] = dropped
    log(f"mesh_model {key}: planted fault (rank 1's routed experts dropped) step 1 logits "
        f"{dropped:.3g} against the bound {MM_TOL['logits']:g}")
    cases[key]["pass"] = ok and dropped > MM_TOL["logits"] and all(
        t["differ"] == t["differ_near_tie"] and t["calls"][0] == t["calls"][1]
        for t in topi.values())
    f32_check(key, b[0]["f32"], r["f32"])

    f, r = got2["pod"], ref["pod"]
    errs = {"mean gradient": float((f[0]["grads"] - r["mean"]).abs().max()
                                   / r["mean"].abs().max())}
    ok = row("(f) compress_psum_pod on 2 x 2 (pod x data)", errs, MM_TOL["pod"],
             [dict(peak=0) for _ in f], [x["ms"] for x in f],
             f"; error buffers {f[0]['err_shape']}, max {f[0]['err_max']:.3g}")
    cases["(f) compress_psum_pod on 2 x 2 (pod x data)"]["pass"] = (
        ok and f[0]["err_shape"] == (plan["pod"]["mesh"][0], plan["pod"]["n"])
        and f[0]["err_max"] > 0)
    return cases


def _mm_change_err(got, want, init) -> float:
    """Relative L2 of a leaf's change since ``init`` against the one card's
    change; where the one card's is 0 (a bfloat16 norm weight at 1.0 does
    not move by 3 x lr), 0 if the mesh's is 0 too, else 1."""
    import torch

    d = torch.linalg.vector_norm((want - init).double())
    if d == 0:
        return float(not torch.equal(got, want))
    return _rel_l2(got - init, want - init)


def _mm_concat_topi(ranks, n_model: int, which: str) -> list:
    """Each MoE call's routing of the mesh's tokens, in the one-card
    order: the rows of model rank 0 of every data row, in data order."""
    import torch

    calls = [r["topi"] if which == "decode" else r["prefill"]["topi"]
             for i, r in enumerate(ranks) if i % n_model == 0]
    return [dict(topi=torch.cat([p["topi"] for p in parts]),
                 gap=torch.cat([p["gap"] for p in parts])) for parts in zip(*calls)]

# ---------------------------------------------------------------- dry run

# (iii): published cells on the production 16 x 16 mesh, faked on the card.
DRY_FULL = (("qwen3-4b", "train_4k"), ("deepseek-v3-671b", "train_4k"),
            ("anytime-ir", "serve_anytime"))
# (ii): mesh_model (c)'s measured per-rank peak over the dry run's predicted
# one lies in this band, for its 2 x 2 and its 4 x 1 step each; stated in
# PERF.md before the first chip run (the allocator's rounding, the cuBLAS
# workspace and gloo's staging are not modelled; the dry run keeps a
# storage until Python frees it).
DRY_PEAK_BAND = (0.75, 1.25)
DRY_TIMEOUT_S = 900  # the dry-run worker's jobs, waited for after mesh_model
EXTRA_POOLS: list = []  # worker pools a phase starts; main() stops them all
RATE_MATMUL_N = 8192  # (iv): one bf16 matmul of this size, CUDA events
RATE_COPY_BYTES = 4 * 2**30  # (iv): one device-to-device copy of 4 GiB


def dry_mesh_full(src: str, device: str, plan) -> dict:
    """Worker: (ii) mesh_model (c)'s two steps (2 x 2, then 4 x 1 after the
    restore) and (iii) the ``DRY_FULL`` cells, each under ``FakeTensorMode``
    on fake ``device`` tensors over a fake group of 512 ranks."""
    import dataclasses
    import os

    os.nice(10)  # off the smoke's critical path: yield to the card's feeders
    sys.path.insert(0, src)
    import torch
    from repro_torch.configs.registry import ARCHS
    from repro_torch.launch import dryrun

    torch.set_num_threads(1)
    p = plan["train"]
    arch = ARCHS[p["arch"]]
    cfg = dataclasses.replace(arch.model_config(not plan["full"]), **p["cut"])

    def tokens(rows):
        return {"tokens": torch.empty((rows, p["seq"]), dtype=torch.int32, device="meta")}

    out = {"mesh_model": {}, "full": {}}
    for mesh, rows in ((p["mesh"], p["batch"]), (p["restore_mesh"], p["after_batch"])):
        out["mesh_model"]["x".join(map(str, mesh))] = dryrun.run_cell(
            p["arch"], "train_4k", mesh_shape=mesh, cfg=cfg, batch_shapes=tokens(rows),
            device=device)
    for a, shape in DRY_FULL:
        out["full"][f"{a}/{shape}"] = dryrun.run_cell(a, shape, "single", device=device)
    return out


def ir_dry_spec(arrays, tables, cfg) -> dict:
    """What (i) needs of ``arch_ir``'s inputs: shapes, types, the config and
    the real bytes of the arrays and tables."""
    import numpy as np
    import torch

    fields = ("docs", "impacts", "blk_start", "blk_len", "blk_maximp", "range_starts",
              "doc_base")
    arrs = {f: getattr(arrays, f) for f in fields}
    tabs = [t if isinstance(t, torch.Tensor) else np.asarray(t) for t in tables]
    return dict(
        arrays={f: (tuple(t.shape), str(t.dtype).removeprefix("torch.")) for f, t in arrs.items()},
        tables=[(tuple(t.shape), str(t.dtype).removeprefix("torch.")) for t in tabs],
        s_pad=arrays.s_pad, k=arrays.k, cfg=dict(cfg),
        bytes=sum(t.numel() * t.element_size() for t in arrs.values())
        + sum(t.numel() * t.element_size() if isinstance(t, torch.Tensor) else t.nbytes
              for t in tabs))


def dry_ir(src: str, device: str, spec: dict) -> dict:
    """Worker: (i) the registry's ``anytime-ir`` step that ``arch_ir`` runs
    on the card, again on fake ``device`` tensors of the same shapes."""
    sys.path.insert(0, src)
    import torch
    from repro_torch.configs.registry import ARCHS
    from repro_torch.launch import dryrun
    from repro_torch.serve.distributed_ir import ShardedIndexArrays
    from torch._subclasses.fake_tensor import FakeTensorMode

    def fake(sd):
        return torch.empty(sd[0], dtype=getattr(torch, sd[1]), device=device)

    step, _ = ARCHS["anytime-ir"].build_step(spec["cfg"], "serve_anytime")
    with FakeTensorMode(allow_non_fake_inputs=True):
        arrays = ShardedIndexArrays(**{f: fake(v) for f, v in spec["arrays"].items()},
                                    s_pad=spec["s_pad"], k=spec["k"])
        tables = tuple(fake(t) for t in spec["tables"])
        return dryrun.measure_step(step, (arrays, {"tables": tables}))


def measured_rates(dev) -> dict:
    """(iv): one 8192^3 bf16 ``torch.matmul`` and one 4 GiB device-to-device
    copy, each timed with CUDA events (10 calls after 3), beside the data
    sheet's peaks (``launch/roofline.py``); the copy moves its bytes twice
    (read and write)."""
    import torch
    from repro_torch.launch import roofline

    n = RATE_MATMUL_N
    a = torch.randn((n, n), device=dev, dtype=torch.bfloat16)
    b = torch.randn((n, n), device=dev, dtype=torch.bfloat16)
    ms = time_ms(lambda: torch.matmul(a, b), iters=10, warmup=3)
    del a, b
    flops = 2.0 * n ** 3 / (ms / 1e3)
    x = torch.empty(RATE_COPY_BYTES, dtype=torch.uint8, device=dev)
    y = torch.empty_like(x)
    cms = time_ms(lambda: y.copy_(x), iters=10, warmup=3)
    del x, y
    torch.cuda.empty_cache()
    rate = 2.0 * RATE_COPY_BYTES / (cms / 1e3)
    res = dict(matmul_ms=ms, matmul_flops=flops, peak_flops=roofline.PEAK_FLOPS,
               matmul_share=flops / roofline.PEAK_FLOPS, copy_ms=cms, copy_bytes_per_s=rate,
               peak_bytes_per_s=roofline.HBM_BW, copy_share=rate / roofline.HBM_BW)
    log(f"dryrun (iv) measured rates: bf16 matmul {n}^3 {ms:.3f} ms = {flops / 1e12:.1f} "
        f"TFLOP/s ({res['matmul_share']:.3f} of the data sheet's "
        f"{roofline.PEAK_FLOPS / 1e12:.1f}); copy of {RATE_COPY_BYTES / 2**30:.0f} GiB "
        f"{cms:.3f} ms = {rate / 1e12:.3f} TB/s read + written ({res['copy_share']:.3f} of "
        f"{roofline.HBM_BW / 1e12:.2f} TB/s)")
    return res


def _gib(b) -> float:
    return b / 2**30


def dryrun_phase(jobs: dict, record: dict, dev) -> dict:
    """The dry run held against this run's own measurements: (i) the
    ``anytime-ir`` step's argument bytes equal to the real arrays' and
    tables' and its launches to ``arch_ir``'s, (ii) mesh_model (c)'s
    per-rank parameter and moment bytes equal and each step's peak (2 x 2,
    then 4 x 1) within ``DRY_PEAK_BAND`` of its own prediction, (iii) the
    published cells, (iv) the measured rates."""
    import torch

    t0 = time.perf_counter()
    got = jobs["mesh"].get(timeout=DRY_TIMEOUT_S)
    ir = jobs["ir"].get(timeout=DRY_TIMEOUT_S)
    res = dict(wait_s=time.perf_counter() - t0, ir=ir, **got)
    spec, arch = record["ir"]["arch_dry"], record["ir"]["arch"]
    mem = ir["memory"]
    log(f"dryrun (i) anytime-ir registry step on fake card tensors: arguments "
        f"{mem['argument_size_in_bytes']} B (real arrays and tables {spec['bytes']} B), "
        f"peak {_gib(mem['peak_memory_in_bytes']):.3f} GiB, launches {ir['kernel_launches']} "
        f"(arch_ir measured {arch['serve_anytime']['launches']} traverse)")
    check(mem["argument_size_in_bytes"] == spec["bytes"],
          f"dryrun (i): {mem['argument_size_in_bytes']} argument bytes, the real arrays "
          f"and tables hold {spec['bytes']}")
    check(ir["kernel_launches"] == {"traverse": arch["serve_anytime"]["launches"]} == {
        "traverse": 1}, f"dryrun (i): launches {ir['kernel_launches']}")
    ranks = record["mesh_model"]["train_ranks"]
    mm = got["mesh_model"]
    (k22, d22), (k41, d41) = mm.items()
    for key, d, want in ((k22, d22, ranks[0]), (k41, d41, ranks[0]["after"])):
        log(f"dryrun (ii) mesh_model (c) {key}: parameters {d['arguments']['params']} B "
            f"(measured {want['param_bytes']}), moments {d['arguments']['moments']} B "
            f"(measured {want['moment_bytes']}); predicted peak "
            f"{_gib(d['memory']['peak_memory_in_bytes']):.3f} GiB (arguments "
            f"{_gib(d['memory']['argument_size_in_bytes']):.3f}, temp "
            f"{_gib(d['memory']['temp_size_in_bytes']):.3f}), collectives "
            f"{d['collectives']['count_by_kind']}")
        check(d["arguments"]["params"] == want["param_bytes"]
              and d["arguments"]["moments"] == want["moment_bytes"],
              f"dryrun (ii) {key}: parameter/moment bytes differ from the measured ones")
    lo, hi = DRY_PEAK_BAND
    res["peak"] = {}
    for i, (key, d) in enumerate(((k22, d22), (k41, d41))):
        predicted = d["memory"]["peak_memory_in_bytes"]
        measured = max(r["step_peaks"][i] for r in ranks)
        ratio = measured / predicted
        res["peak"][key] = dict(predicted=predicted, measured=measured, ratio=ratio,
                                band=DRY_PEAK_BAND)
        log(f"dryrun (ii) mesh_model (c) {key} step, per-rank peak: measured "
            f"{_gib(measured):.3f} GiB, predicted {_gib(predicted):.3f} GiB, ratio "
            f"{ratio:.3f} (band {lo}-{hi})")
        check(lo <= ratio <= hi, f"dryrun (ii) {key}: measured/predicted peak {ratio:.3f} "
              f"outside {DRY_PEAK_BAND}")
    total = torch.cuda.get_device_properties(dev).total_memory if dev.type == "cuda" else 0
    for cell, d in got["full"].items():
        m = d["memory"]
        fits = "-" if not total else m["peak_memory_in_bytes"] <= total
        log(f"dryrun (iii) {cell} on 16 x 16: arguments {_gib(m['argument_size_in_bytes']):.3f}"
            f" GiB, peak {_gib(m['peak_memory_in_bytes']):.3f} GiB (fits "
            f"{_gib(total):.2f} GiB: {fits}), {d['per_device_flops']:.4g} FLOPs and "
            f"{d['per_device_bytes_accessed']:.4g} B a device, collectives "
            f"{d['collectives']['total_bytes']:.4g} B {d['collectives']['count_by_kind']}, "
            f"launches {d['kernel_launches']}, traced in {d['trace_s']} s")
    res["rates"] = measured_rates(dev) if dev.type == "cuda" else None
    res["wall_s"] = time.perf_counter() - t0
    log(f"dryrun phase {res['wall_s']:.1f} s after mesh_model (waited {res['wait_s']:.1f} s "
        "for the worker)")
    return res


def run_dryrun(pool, dev=None) -> None:
    """``--dryrun``: every cell of the registry on both production meshes
    and the perf variants (``launch/dryrun.py``, fake card tensors, one
    worker per core but one), the roofline table; fails if a cell fails or
    a perf variant's peak exceeds the card's memory (numbers in
    ``chiprun_out/dryrun/``, ``chiprun_out/roofline.json`` and
    ``chiprun_out/chip_smoke_dryrun.json``)."""
    import os

    import torch
    from repro_torch.launch import dryrun, roofline

    del pool
    t_start = time.perf_counter()
    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    log(f"card: {smi} | torch {torch.__version__}, CUDA {torch.version.cuda}")
    dev = torch.device("cuda", 0) if dev is None else dev
    out_dir = ROOT / "chiprun_out" / "dryrun"
    cells = dryrun.sweep_cells()
    n_jobs = max(1, (os.cpu_count() or 2) - 1)
    failures = dryrun.run_cells(cells, device="cuda", out_dir=str(out_dir), force=True,
                                jobs=n_jobs)
    sweep_s = time.perf_counter() - t_start
    log(f"dryrun sweep: {len(cells)} cells in {sweep_s:.1f} s on {n_jobs} workers, "
        f"{len(failures)} failed {failures}")
    total = torch.cuda.get_device_properties(dev).total_memory
    variants = {}
    for arch, shape, mesh, variant in dryrun.PERF_VARIANTS:
        path = out_dir / Path(dryrun._cell_path("", arch, shape, mesh, variant)).name
        d = json.loads(path.read_text())
        peak = d.get("memory", {}).get("peak_memory_in_bytes")
        variants[path.stem] = dict(ok=d["ok"], peak=peak, fits=bool(d["ok"] and peak <= total))
        log(f"dryrun variant {path.stem}: peak "
            f"{'-' if peak is None else f'{_gib(peak):.3f}'} GiB against the card's "
            f"{_gib(total):.2f} GiB: {'fits' if variants[path.stem]['fits'] else 'DOES NOT FIT'}")
    rows = roofline.collate(str(out_dir))
    (ROOT / "chiprun_out" / "roofline.json").write_text(json.dumps(rows, indent=1))
    for mesh in ("single", "multi"):
        log(f"roofline ({mesh}-pod mesh; H100 data-sheet peaks):")
        for line in roofline.to_markdown(rows, mesh).splitlines():
            log("  " + line)
    rates = measured_rates(dev)
    record = dict(card=smi, cells=len(cells), failures=failures, sweep_s=sweep_s,
                  variants=variants, total_memory=total, rates=rates, rows=rows)
    (ROOT / "chiprun_out" / "chip_smoke_dryrun.json").write_text(
        json.dumps(record, indent=1, default=str))
    check(not failures, f"dryrun: cells failed {failures}")
    over = [k for k, v in variants.items() if not v["fits"]]
    check(not over, f"dryrun: perf variants over the card's {_gib(total):.2f} GiB: {over}")
    log(f"dryrun wall time {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


def nvidia_smi() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(proc.returncode == 0 and proc.stdout.strip(),
          f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


def run(pool, dev=None, preset: dict = PRESET, scale: dict = SCALE) -> None:
    import shutil

    import torch

    from repro_torch import index_io
    from repro_torch.core.anytime import Reactive
    from repro_torch.core.range_daat import Engine
    from repro_torch.kernels.embedding_bag import kernel as bag_kernel
    from repro_torch.kernels.range_scorer import kernel
    from repro_torch.launch import serve

    t_start = time.perf_counter()
    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    log(f"card: {smi} | torch {torch.__version__}, CUDA {torch.version.cuda}")
    record = {"card": smi, "device": name, "torch": torch.__version__,
              "cuda": torch.version.cuda}

    # Host builds in worker processes, overlapping the card's phases.
    # The scale index goes through build_index_cached under .cache/: a hit
    # needs the entry from an earlier run in this checkout.
    jobs = {
        "preset": pool.apply_async(build_corpus_index, (str(SRC), preset, N_QUERIES)),
        "scale": pool.apply_async(build_corpus_index, (str(SRC), scale, N_QUERIES,
                                                       str(ROOT / ".cache"))),
        "chain": pool.apply_async(build_chain, (str(SRC), preset, str(CHAIN_DIR))),
        "ir": pool.apply_async(build_ir, (str(SRC), preset, N_QUERIES)),
        "mips": pool.apply_async(build_mips, (str(SRC), MIPS)),
    }

    dev = torch.device("cuda", 0) if dev is None else dev
    # One nvcc per source, started together.
    libs = {"range_scorer.cu": kernel, "embedding_bag.cu": bag_kernel}
    with ThreadPoolExecutor(len(libs)) as ex:
        builds = {src: ex.submit(mod.build) for src, mod in libs.items()}
        record["nvcc_s"] = {}
        for src, fut in builds.items():
            _, build_s, build_log = fut.result()
            log(f"nvcc build {src} (sm_90a, {' '.join(libs[src].NVCC_FLAGS)}): "
                f"{build_s:.2f} s")
            lines = ptxas_lines(build_log)
            for line in ptxas_summary(lines):
                log(f"  ptxas: {line}")
            record["nvcc_s"][src] = build_s
            record.setdefault("ptxas", {})[src] = lines
    # The dry run's worker (fake card tensors, host CPU only, at low
    # priority) runs beside the card's phases; dryrun_phase holds its
    # records against theirs.
    dry_pool = multiprocessing.get_context("spawn").Pool(1)
    EXTRA_POOLS.append(dry_pool)
    dry_jobs = {"mesh": dry_pool.apply_async(dry_mesh_full, (str(SRC), "cuda", MM_PLAN))}

    parity = Parity()
    t0 = time.perf_counter()
    kernel_phase(dev, parity)
    t1 = time.perf_counter()
    traverse_phase(dev, parity)
    t2 = time.perf_counter()
    stacked_traverse_phase(dev, parity)
    log(f"kernel phase {t1 - t0:.1f} s, traverse phase {t2 - t1:.1f} s, stacked-shard "
        f"traverse phase {time.perf_counter() - t2:.1f} s")
    log("kernels: " + ", ".join(
        f"{n} ({parity.cases[n]} cases, {getattr(kernel, n).launches} launches)"
        for n in SCORER_KERNELS) + ": parity ok (bitwise)")

    index, queries, builds = receive_index(jobs["preset"], "preset")
    # The mesh phase's ranks load the preset from an artifact.
    shutil.rmtree(MESH_DIR, ignore_errors=True)
    index_io.save_index(index, str(MESH_DIR / "preset"))
    _pickle(MESH_DIR / "preset_queries.pkl", list(queries))
    record["preset"] = dict(build=builds, parity=four_way_parity(index, queries, "preset", dev))
    t0 = time.perf_counter()
    record["preset"]["telemetry"] = telemetry_parity(index, queries, dev)
    log(f"telemetry parity {time.perf_counter() - t0:.1f} s")
    del index
    t0 = time.perf_counter()
    record["chain"] = chain_phase(jobs["chain"], dev)
    log(f"chain phase (control (e) included) {time.perf_counter() - t0:.1f} s")
    # Partitioned IR and anytime MIPS, while the scale build runs on.
    t0 = time.perf_counter()
    record["ir"] = ir_phase(jobs["ir"], dev)
    dry_jobs["ir"] = dry_pool.apply_async(dry_ir, (str(SRC), "cuda", record["ir"]["arch_dry"]))
    t1 = time.perf_counter()
    record["mips"] = mips_phase(jobs["mips"], dev)
    log(f"partitioned IR phase {t1 - t0:.1f} s, MIPS phase {time.perf_counter() - t1:.1f} s")
    # The architecture registry: reduced configs against the CPU port, the
    # LMs and the towers at published widths.
    record["arch"] = arch_phase(dev, pool)
    # Training: reduced parity, qwen3-4b at published widths, resume, the
    # published GraphSAGE and tower configs.
    record["train"] = train_phase(dev, pool)
    record["mesh_model"] = mesh_model_phase(dev, pool)
    record["dryrun"] = dryrun_phase(dry_jobs, record, dev)
    dry_pool.terminate()

    index, queries, builds = receive_index(jobs["scale"], "scale")
    record["scale"] = dict(build=builds, nnz=index.nnz, n_blocks=index.n_blocks,
                           device_bytes=index.device_bytes("int8", "packed"))
    # The anytime loop's parity at scale on 64 queries: the scale phases
    # follow the slowest host build, so they set the smoke's wall time.
    record["scale"]["parity"] = four_way_parity(index, queries, "scale", dev,
                                                n_anytime=SCALE_ANYTIME_QUERIES,
                                                n_plain=SCALE_PLAIN_QUERIES)
    # The standalone scatter and decode, off the engine's path, on their own.
    blocks_launches = score_blocks_path(index, queries, parity, dev)
    record["scale"]["score_blocks_launches"] = blocks_launches
    record["scale"]["batch_parity"] = batch_parity(index, queries, dev,
                                                   n_plain=SCALE_PLAIN_QUERIES)
    record["scale"]["wide_k_parity"] = wide_k_parity(index, queries, dev)
    t0 = time.perf_counter()
    record["scale"]["inflight_parity"] = inflight_parity(index, queries, dev)
    t1 = time.perf_counter()
    record["scale"]["sharded_parity"] = sharded_parity(
        index, queries, dev, n_plain=SCALE_SHARDED_PLAIN_QUERIES)
    log(f"in-flight parity {t1 - t0:.1f} s, sharded parity {time.perf_counter() - t1:.1f} s")

    # The main path: the serving loop over the kernels' engine.
    engine = Engine(index, k=10, device=dev, impact_dtype="int8", docs_format="packed")
    log(f"scale: serving engine int8/packed, s_pad {engine.s_pad} "
        f"({kernel.acc_placement(engine.s_pad)} accumulator), device bytes "
        f"{sum(t.nbytes for t in engine.dix if t is not None)}")
    reset_launches()
    stats = serve.serve(engine, queries, Reactive(alpha=1.0, beta=1.2, q=0.01))
    launches = read_launches()
    # One range_step per range of the anytime loop; one traverse per
    # warm-up traversal.
    check_launches(launches, {"range_step": stats["ranges"],
                              "traverse": stats["traversals"]}, "serving window")
    runs = stats["runs"]
    log(serve.format_report("reactive", stats))
    log(f"main path launches: {launches} over {runs} query runs, "
        f"{stats['ranges']} ranges scored by the anytime loop, "
        f"{stats['traversals']} warm-up traversals ({stats['traverse_ranges']} ranges)")
    record["scale"]["serve"] = stats
    record["scale"]["main_path_launches"] = launches

    # This slice's path: the batch serving window, launch/serve.py --mode batch.
    reset_launches()
    bstats = serve.serve_batch(engine, queries, BATCH)
    batch_launches = read_launches()
    # One traverse per dispatch (warm-up, probe, warm batch, window); one
    # range_step per range of the calibration's anytime runs.
    check_launches(batch_launches, {"traverse": bstats["batches"],
                                    "range_step": bstats["ranges"]},
                   "batch serving window")
    log(serve.format_report("batch", bstats))
    log(f"batch serving window launches: {batch_launches} over {bstats['batches']} "
        f"dispatches at batch {BATCH}, shapes {bstats['shapes']}, final alpha "
        f"{bstats['final_alpha']:.3f}")
    record["scale"]["serve_batch"] = bstats
    record["scale"]["batch_path_launches"] = batch_launches

    # This slice's paths: launch/serve.py --mode inflight and --mode sharded.
    reset_launches()
    istats = serve.serve_inflight(engine, queries, BATCH, 1)
    inflight_launches = read_launches()
    # One traverse per step (probe and window); one range_step per range of
    # the calibration's anytime runs.
    check_launches(inflight_launches, {"traverse": istats["steps"],
                                       "range_step": istats["ranges"]},
                   "in-flight serving window")
    log(serve.format_report("inflight", istats))
    log(f"in-flight serving window launches: {inflight_launches} over {istats['steps']} "
        f"steps ({istats['window_steps']} in the window) at {BATCH} slots, quantum 1, "
        f"shapes {istats['shapes']}, final alpha {istats['final_alpha']:.3f}")
    record["scale"]["serve_inflight"] = istats
    record["scale"]["inflight_path_launches"] = inflight_launches
    reset_launches()
    sstats = serve.serve_batch(engine, queries, BATCH, n_shards=SHARDS)
    sharded_launches = read_launches()
    check_launches(sharded_launches, {"traverse": sstats["batches"],
                                      "range_step": sstats["ranges"]},
                   "sharded serving window")
    log(serve.format_report("sharded", sstats))
    log(f"sharded serving window launches: {sharded_launches} over {sstats['batches']} "
        f"dispatches at batch {BATCH}, {sstats['shards']} shards (mass {sstats['mass']}), "
        f"shapes {sstats['shapes']}, final alpha {sstats['final_alpha']:.3f}")
    record["scale"]["serve_sharded"] = sstats
    record["scale"]["sharded_path_launches"] = sharded_launches

    # This slice's path: the control plane on the same engine, S = 4.
    t0 = time.perf_counter()
    control, plane = control_parity(index, queries, engine, dev)
    control["reshard"] = reshard_phase(plane, index, queries, engine, dev)
    control["window"] = control_window(plane, engine, queries, sstats["sla_ms"])
    del plane
    # launch/serve.py --mode control: healthy, shard 0 down, up, live reshard.
    reset_launches()
    cstats = serve.serve_control(engine, queries, SHARDS, CONTROL_REPLICAS, BATCH)
    check_launches(read_launches(), {"traverse": cstats["batches"],
                                     "range_step": cstats["ranges"]},
                   "control serving window")
    log(serve.format_report("control", cstats))
    log(f"control serving window (--mode control, S={SHARDS}, replicas "
        f"{CONTROL_REPLICAS}, batch {BATCH}): {cstats['degraded']} degraded answers while "
        f"shard 0 was down, reshard {cstats['first_cuts']} -> {cstats['cuts']} in "
        f"{cstats['reshard_steps']} steps with {cstats['served_during_reshard']} queries "
        f"served mid-cutover; {cstats['batches']} traverse launches, one a dispatch")
    control["serve_control"] = cstats
    control_launches = sum(w["dispatches"] for w in control["window"]["control"]) + \
        cstats["batches"]
    record["scale"]["control"] = control
    log(f"control phase {time.perf_counter() - t0:.1f} s")

    # The batch and in-flight windows again, instrumented, before any
    # profiler session; then the artifact phase.
    t0 = time.perf_counter()
    owin = obs_windows(engine, queries)
    record["scale"]["obs_windows"] = owin
    log(f"obs-on windows {time.perf_counter() - t0:.1f} s")
    for mode in ("batch", "inflight"):
        w = owin[mode]
        log(f"obs off/on in turns, {mode} window: q/s off {w['qps']['off']}, on "
            f"{w['qps']['on']}; P99 ms off {w['p99_ms']['off']}, on {w['p99_ms']['on']}; "
            f"median ms per query off {w['ms_per_query']['off']:.4f}, on "
            f"{w['ms_per_query']['on']:.4f}: obs adds {w['added_ms_per_query']:.4f} ms a "
            f"query; last enabled window {w['traces']} traces, {w['dispatches']} "
            f"profiled dispatches, {w['compiles']} compiles, 0 recompiles, SLO states "
            f"{w['slo_state']}")
    t0 = time.perf_counter()
    art = record["scale"]["artifact"] = artifact_phase(index, queries, engine, dev)
    log(f"artifact phase {time.perf_counter() - t0:.1f} s; cold start from the artifact "
        f"{art['cold_start_s']:.2f} s against this run's host build of the same index "
        f"{builds['corpus_s'] + builds['index_s']:.1f} s (corpus and index)")
    # The retrieval mesh: ranks spawned here share the card through gloo.
    record["mesh"] = mesh_phase(engine, queries, art["paths"]["art"],
                                art["paths"]["shards_art"], str(MESH_DIR / "preset"), dev)
    shutil.rmtree(ARTIFACT_DIR, ignore_errors=True)
    shutil.rmtree(MESH_DIR, ignore_errors=True)

    # Profiler sessions only after the serving window: opened before it,
    # they slowed its host time per range (PERF.md).
    prof = profile_serving(engine, queries)
    record["scale"]["profile"] = prof
    log(f"profile ({prof['queries']} unbudgeted queries, {prof['ranges']} ranges): "
        f"wall {prof['wall_ms']:.1f} ms, device busy {prof['device_busy_ms']:.2f} ms, "
        f"idle share {prof['idle_share']:.4f}, {prof['host_ms_per_range']:.4f} ms "
        f"host, {prof['device_busy_us_per_range']:.2f} us device busy and "
        f"{prof['device_ops_per_range']:.2f} device ops per range; plan "
        f"{prof['plan_ms_per_query']:.3f} ms per query")
    check(prof["device_ops_per_range"] <= 3,
          f"{prof['device_ops_per_range']:.2f} device ops per range, more than 3")
    for row in prof["top"]:
        log(f"  {row['us']:10.1f} us  x{row['count']:<6d} {row['name']}")
    bprof = profile_batches(engine, queries)
    record["scale"]["profile_batches"] = bprof
    log(f"batch profile ({bprof['queries']} unbudgeted queries, batch {bprof['batch']}, "
        f"{bprof['ranges']} lane-ranges): per batch plan {bprof['mean_plan_ms']:.3f} ms, "
        f"dispatch {bprof['mean_dispatch_ms']:.3f} ms, device {bprof['mean_device_ms']:.3f}"
        f" ms, read {bprof['mean_read_ms']:.3f} ms; window wall {bprof['wall_ms']:.1f} ms, "
        f"device busy {bprof['device_busy_ms']:.3f} ms, idle share "
        f"{bprof['idle_share']:.4f}, {bprof['htod_copies']} host-to-device copies over "
        f"{bprof['dispatches']} dispatches; traverse_kernel "
        f"{bprof['traverse_device_us']:.1f} us "
        f"over {bprof['traverse_launches']} launches = "
        f"{bprof['traverse_us_per_lane_range']:.2f} us per scored lane-range")
    for row in bprof["batches"]:
        log("  batch: " + ", ".join(f"{k} {v:.3f}" if isinstance(v, float) else
                                    f"{k} {v}" for k, v in row.items()))
    for row in bprof["top"]:
        log(f"  {row['us']:10.1f} us  x{row['count']:<6d} {row['name']}")

    iprof = profile_inflight(engine, queries)
    record["scale"]["profile_inflight"] = iprof
    # The obs profiler's own split beside the smoke's (monkeypatched) one.
    for mode, mine in (("batch", {k: bprof[f"mean_{k}_ms"] for k in
                                  ("plan", "dispatch", "device", "read")}),
                       ("inflight", {k: iprof[f"mean_{k}_ms"] for k in
                                     ("upload", "dispatch", "device", "plan", "read")})):
        split = owin[mode]["split"]
        log(f"obs profiler split per {'batch' if mode == 'batch' else 'step'} ({mode}, "
            f"obs on): " + ", ".join(f"{k.removesuffix('_ms')} {v:.3f} ms"
                                     for k, v in split.items())
            + "; the smoke's split: " + ", ".join(f"{k} {v:.3f} ms"
                                                  for k, v in mine.items()))
    log(f"in-flight profile ({iprof['queries']} unbudgeted queries, {iprof['slots']} slots, "
        f"quantum {iprof['quantum']}, {iprof['steps']} steps, {iprof['ranges']} "
        f"lane-ranges): per step upload {iprof['mean_upload_ms']:.3f} ms, dispatch "
        f"{iprof['mean_dispatch_ms']:.3f} ms, device {iprof['mean_device_ms']:.3f} ms, "
        f"plan {iprof['mean_plan_ms']:.3f} ms, read {iprof['mean_read_ms']:.3f} ms; window "
        f"wall {iprof['wall_ms']:.1f} ms, device busy {iprof['device_busy_ms']:.3f} ms, "
        f"idle share {iprof['idle_share']:.4f}, {iprof['htod_copies']} host-to-device "
        f"copies over {iprof['dispatches']} steps ({iprof['htod_per_step']:.2f} per step); "
        f"traverse_kernel {iprof['traverse_us_per_step']:.2f} us per step")
    for row in iprof["top"]:
        log(f"  {row['us']:10.1f} us  x{row['count']:<6d} {row['name']}")
    sprof = profile_sharded(engine, queries)
    record["scale"]["profile_sharded"] = sprof
    log(f"sharded profile ({sprof['queries']} unbudgeted queries, batch {sprof['batch']}, "
        f"{sprof['shards']} shards, {sprof['lane_ranges']} lane-ranges): per batch plan "
        f"{sprof['mean_plan_ms']:.3f} ms, shard-plan {sprof['mean_shard_plan_ms']:.3f} ms, "
        f"staging {sprof['mean_stage_ms']:.3f} ms, dispatch {sprof['mean_dispatch_ms']:.3f}"
        f" ms, device {sprof['mean_device_ms']:.3f} ms, read {sprof['mean_read_ms']:.3f} "
        f"ms; window wall {sprof['wall_ms']:.1f} ms, device busy "
        f"{sprof['device_busy_ms']:.3f} ms, idle share {sprof['idle_share']:.4f}, "
        f"{sprof['htod_copies']} host-to-device copies over {sprof['dispatches']} "
        f"dispatches; traverse_kernel {sprof['traverse_device_us']:.1f} us over "
        f"{sprof['traverse_launches']} launches = "
        f"{sprof['traverse_us_per_lane_range']:.2f} us per scored lane-range")
    for row in sprof["batches"]:
        log("  batch: " + ", ".join(f"{k} {v:.3f}" if isinstance(v, float) else
                                    f"{k} {v}" for k, v in row.items()))
    for row in sprof["top"]:
        log(f"  {row['us']:10.1f} us  x{row['count']:<6d} {row['name']}")

    ti = TimingInputs(index, queries, dev)
    record["phases"] = phase_timings(ti, parity, dev)
    timings = kernel_timings(index, queries, parity, dev, ti)
    kernels = []
    # The standalone kernels report their own path's launches (score_blocks);
    # range_step the serving window's, traverse the batch serving window's.
    ir_launches = sum(record["ir"][f]["launches"] for f in ("unbudgeted", "budgeted")) + \
        sum(r["launches"] for r in record["ir"]["arch"].values())
    path_launches = dict(blocks_launches, range_step=launches["range_step"],
                         traverse=batch_launches["traverse"]
                         + inflight_launches["traverse"] + sharded_launches["traverse"]
                         + control_launches + ir_launches + record["mesh"]["launches"])
    replaces = {"scatter_accumulate": f"{TPU_SCORER}:47",
                "unpack_locals": f"{TPU_SCORER}:107",
                "range_step": f"{TPU_SCORER}:47 + {TPU_SCORER}:107",
                "traverse": f"{TPU_SCORER}:47 + {TPU_SCORER}:107"}
    for kname in ("scatter_accumulate", "unpack_locals", "range_step", "traverse"):
        tm = timings[kname]
        lib = "-" if tm["library_ms"] is None else f"{tm['library_ms'] * 1e3:.2f} us"
        per_query = {
            "range_step": f"{launches[kname] / runs:.2f} launches/query on the serving "
                          "window",
            "traverse": f"{path_launches[kname]} launches on the batch, in-flight, "
                        f"sharded and control windows, the partitioned-IR and "
                        f"anytime-ir calls and the mesh phase's ranks "
                        f"({batch_launches['traverse']}, {inflight_launches['traverse']}, "
                        f"{sharded_launches['traverse']}, {control_launches}, "
                        f"{ir_launches}, {record['mesh']['launches']})",
        }.get(kname, f"{path_launches[kname]} launches on score_blocks, 0 on the main "
                     "path")
        log(f"{kname} [{tm['shape']}]: {tm['ms'] * 1e3:.2f} us/call, plain "
            f"{tm['plain_ms'] * 1e3:.2f} us, library {lib}, bound "
            f"{tm['bound_ms'] * 1e3:.4f} us ({tm['bytes']} B), {per_query}; "
            f"device-only: kernel {tm['kernel_device_us']:.2f} us, wrapper "
            f"{tm['wrapper_device_us']:.2f} us, plain {tm['plain_device_us']:.2f} us"
            + ("" if tm["library_device_us"] is None else
               f", library {tm['library_device_us']:.2f} us"
               + (f" (of which its zero fill {tm['library_fill_device_us']:.2f} us)"
                  if "library_fill_device_us" in tm else ""))
            + ("" if "caller_ms" not in tm else
               f"; through traverse_lanes {tm['caller_ms'] * 1e3:.2f} us/call, its shape "
               f"rule {tm['rule_us']:.3f} us a call on the host"))
        kernels.append({
            "name": kname, "route": "cuda", "source": CU_SOURCE,
            "replaces": replaces[kname],
            "launches": path_launches[kname], "max_abs_err": parity.max_err[kname],
            "ms": tm["ms"], "plain_ms": tm["plain_ms"], "bound_ms": tm["bound_ms"],
            "bound_by": "bytes", "library_ms": tm["library_ms"],
        })
    floor = record["phases"]["dependency_floor_us"]  # a step's, either kernel
    log("range_step: latency, not its byte bound, limits it (the launch, then "
        "dependent global rounds and barriers; phase table above): "
        f"{timings['range_step']['kernel_device_us']:.2f} us device-only against a "
        f"{timings['range_step']['bound_ms'] * 1e6:.1f} ns byte bound and a "
        f"{floor:.3f} us dependency floor")
    tr = timings["traverse"]
    log(f"traverse: {tr['kernel_device_us']:.2f} us device-only for {tr['ranges']} "
        f"lane-ranges = {tr['kernel_device_us'] / max(tr['ranges'], 1):.2f} us per "
        f"lane-range (throughput over {BATCH} lanes at once); per step of the "
        f"slowest lane ({tr['slowest_lane_ranges']} ranges) "
        f"{tr['kernel_device_us'] / max(tr['slowest_lane_ranges'], 1):.2f} us; "
        f"against a {tr['bound_ms'] * 1e3:.4f} us byte bound and a "
        f"{floor * tr['slowest_lane_ranges']:.3f} us dependency floor "
        f"({floor:.3f} us a step)")
    st = timings["traverse_sharded"]
    log(f"traverse at the sharded shape [{st['shape']}]: {st['ms'] * 1e3:.2f} us/call, "
        f"device-only {st['kernel_device_us']:.2f} us for {st['ranges']} lane-ranges = "
        f"{st['kernel_device_us'] / max(st['ranges'], 1):.2f} us per lane-range over "
        f"{BATCH * SHARDS} lanes; per step of the slowest lane "
        f"({st['slowest_lane_ranges']} ranges) "
        f"{st['kernel_device_us'] / max(st['slowest_lane_ranges'], 1):.2f} us; plain "
        f"{st['plain_ms'] * 1e3:.0f} us; against a {st['bound_ms'] * 1e3:.4f} us byte bound "
        f"({st['bytes']} B)")

    record["bag"] = bag_phase(dev, parity)
    record["bag"]["timings"] = bag_timings(dev, parity)
    bulk = record["bag"]["timings"]["mind serve_bulk"]
    kernels.append({
        "name": "bag_reduce", "route": "cuda", "source": BAG_SOURCE,
        "replaces": "src/repro/kernels/embedding_bag/kernel.py:30",
        "launches": record["bag"]["launches"], "max_abs_err": parity.max_err["bag_reduce"],
        "ms": bulk["ms"], "plain_ms": bulk["plain_ms"], "bound_ms": bulk["bound_ms"],
        "bound_by": bulk["bound_by"], "library_ms": bulk["library_ms"],
    })
    record["kernels"] = kernels
    record["timings"] = timings
    record["wall_s"] = time.perf_counter() - t_start
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1, default=str))
    log(f"smoke wall time {record['wall_s']:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


def run_phases(pool, dev=None, scale: dict = SCALE) -> None:
    """``--phases``: the range-scorer build with its ptxas report, then the
    phase timer and the two range kernels' device-only times at the scale
    cell's ``TimingInputs`` (numbers also in ``chiprun_out/chip_smoke_phases.json``)."""
    import torch
    from repro_torch.kernels.range_scorer import kernel

    t_start = time.perf_counter()
    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    log(f"card: {smi} | torch {torch.__version__}, CUDA {torch.version.cuda}")
    job = pool.apply_async(build_corpus_index, (str(SRC), scale, N_QUERIES))
    dev = torch.device("cuda", 0) if dev is None else dev
    _, build_s, build_log = kernel.build()
    log(f"nvcc build range_scorer.cu: {build_s:.2f} s")
    for line in ptxas_summary(ptxas_lines(build_log)):
        log(f"  ptxas: {line}")
    index, queries, _ = receive_index(job, "scale")
    ti = TimingInputs(index, queries, dev)
    parity = Parity()
    record = dict(card=smi, ptxas=ptxas_lines(build_log),
                  phases=phase_timings(ti, parity, dev))
    kw = ti.kw
    record["range_step_device_us"] = device_us(
        functools.partial(kernel.range_step, *ti.step_args, **kw), "range_step_kernel")
    for label, dix, lanes in (("traverse", ti.eng.dix, ti.lanes),
                              ("traverse_sharded", ti.seng.dix, ti.slanes)):
        record[f"{label}_device_us"] = device_us(
            functools.partial(kernel.traverse, dix, *lanes, **kw), "traverse_kernel", 50)
    log("device-only: " + ", ".join(f"{k} {v:.2f}" for k, v in record.items()
                                     if k.endswith("_device_us")))
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke_phases.json").write_text(json.dumps(record, indent=1,
                                                               default=str))
    log(f"phases wall time {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


def run_train(pool, dev=None) -> None:
    """``--train``: the train phase alone, with the full-width checkpoint
    round trip (numbers also in ``chiprun_out/chip_smoke_train.json``)."""
    import torch

    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    log(f"card: {smi} | torch {torch.__version__}, CUDA {torch.version.cuda}")
    dev = torch.device("cuda", 0) if dev is None else dev
    record = dict(card=smi, train=train_phase(dev, pool, full_checkpoint=True))
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke_train.json").write_text(json.dumps(record, indent=1, default=str))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


def run_mesh_model(pool, dev=None) -> None:
    """``--mesh-model``: the model mesh phase alone (numbers also in
    ``chiprun_out/chip_smoke_mesh_model.json``)."""
    import torch

    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    log(f"card: {smi} | torch {torch.__version__}, CUDA {torch.version.cuda}")
    dev = torch.device("cuda", 0) if dev is None else dev
    record = dict(card=smi, mesh_model=mesh_model_phase(dev, pool))
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke_mesh_model.json").write_text(json.dumps(record, indent=1,
                                                                    default=str))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


def main() -> int:
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: FAIL: torch is not importable: {e}", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: FAIL: torch.cuda.is_available() is false; this smoke "
              "needs one CUDA card", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        print(f"chip_smoke: FAIL: {SRC / 'repro_torch'} not found: run from a "
              "checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    ctx = multiprocessing.get_context("spawn")
    pool = ctx.Pool(3)
    try:
        mode = {"--phases": run_phases, "--train": run_train, "--mesh-model": run_mesh_model,
                "--dryrun": run_dryrun}
        flags = [a for a in sys.argv[1:] if a in mode]
        (mode[flags[0]] if flags else run)(pool)
    except SmokeError as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    finally:
        for p in [pool, *EXTRA_POOLS]:
            p.terminate()
            p.join()
    return 0


if __name__ == "__main__":
    sys.exit(main())
