"""A configuration's collection, its index artifact and the reference's results,
made once per checkout and cached under ``anytime_bench/.cache/``.

The collection follows the configuration's ``collection_seed``: a deployment
serves one fixed collection, and the traffic (``--seed``) varies. The first
run of a configuration in a checkout makes the corpus and its topical
partition, builds the port's index from them (``build_index`` with the
partition as its arrangement, the paper's shard map taken as data) and saves
it with the port's ``save_index``; later runs load it. A traffic's query pool
and the reference's trajectories of every pool query (``reference.engine``)
are cached beside it, keyed by the pool's parameters, k and the impact bits.
Everything is published by renaming a finished temporary directory, so a run
that is cut leaves no half-written cache.
"""

from __future__ import annotations

import hashlib
import json
import multiprocessing
import os
import shutil
import time

import numpy as np

from anytime_bench.data import synth
from anytime_bench.reference import engine as ref

__all__ = ["Collection", "CACHE_DIR"]

CACHE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), ".cache")


def _key(obj) -> str:
    return hashlib.sha256(json.dumps(obj, sort_keys=True).encode()).hexdigest()[:12]


def _publish(tmp: str, path: str) -> None:
    try:
        os.replace(tmp, path)
    except OSError:  # another run published it first
        shutil.rmtree(tmp, ignore_errors=True)


def _in_child(fn, *args) -> None:
    """Run ``fn(*args)`` in a spawned process and wait for it: the heavy host
    builds leave the run's own process as lean as a later run's."""
    proc = multiprocessing.get_context("spawn").Process(target=fn, args=args)
    proc.start()
    proc.join()
    if proc.exitcode != 0:
        raise RuntimeError(f"{fn.__name__} failed in its process (exit code {proc.exitcode})")


def _prepare(cfg: dict, cache_dir: str | None, pool: dict | None, artifact: bool) -> None:
    coll = Collection(cfg, cache_dir)
    if artifact:
        coll._build_artifact()
    if pool is not None:
        coll._make_pool(pool)
    coll._log_seconds()


def _build_reference_index(cfg: dict, cache_dir: str | None, bits: int) -> None:
    coll = Collection(cfg, cache_dir)
    path = coll._ref_index_path(bits)
    t0 = time.perf_counter()
    corpus = coll.corpus()
    doc_order, range_ends = synth.topic_partition(corpus)
    ix = ref.build_reference_index(corpus, doc_order, range_ends, bits, cfg["bm25"]["k1"],
                                   cfg["bm25"]["b"])
    tmp = f"{path}.tmp-{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    ref.save_reference_index(ix, tmp)
    _publish(tmp, path)
    coll.seconds[f"reference_index_b{bits}"] = time.perf_counter() - t0
    coll._log_seconds()


def _traj_chunk(args):
    path, pool_terms, k, imp_size, packed = args
    ix = ref.load_reference_index(path)
    return ref.trajectories(ix, pool_terms, k, imp_size, packed)


class Collection:
    """One configuration's cached collection, artifact, pools and reference.

    ``cfg`` is the configuration file's object; ``cache_dir`` defaults to
    ``CACHE_DIR``. ``seconds`` records what each step that ran took.
    """

    def __init__(self, cfg: dict, cache_dir: str | None = None, workers: int = 6):
        self.cfg = cfg
        self.cache_dir = cache_dir
        self.dir = os.path.join(cache_dir or CACHE_DIR, f"{cfg['name']}-{_key(cfg)}")
        self.workers = workers
        self.seconds: dict[str, float] = {}
        self._corpus = None

    # ---------------------------------------------------------- collection
    def corpus(self):
        """The collection (made from the configuration, once per process)."""
        if self._corpus is None:
            c = self.cfg
            t0 = time.perf_counter()
            self._corpus = synth.make_corpus(
                n_docs=c["n_docs"], n_terms=c["n_terms"], n_topics=c["n_ranges"],
                mean_doc_len=c["mean_doc_len"], zipf_s=c["zipf_s"], seed=c["collection_seed"])
            self.seconds["corpus"] = time.perf_counter() - t0
        return self._corpus

    @property
    def artifact(self) -> str:
        return os.path.join(self.dir, "artifact")

    def prepare(self, pool: dict | None, artifact: bool = True) -> bool:
        """Make the port's index artifact (if ``artifact``) and the query
        pool (if ``pool``) where the cache lacks them, in a child process;
        True if anything was made."""
        if (not artifact or os.path.exists(os.path.join(self.artifact, "manifest.json"))) \
                and (pool is None or os.path.exists(self._pool_path(pool))):
            return False
        _in_child(_prepare, self.cfg, self.cache_dir, pool, artifact)
        return True

    def _log_seconds(self) -> None:
        os.makedirs(self.dir, exist_ok=True)
        path = os.path.join(self.dir, "build_seconds.json")
        old = {}
        if os.path.exists(path):
            with open(path) as f:
                old = json.load(f)
        with open(path, "w") as f:
            json.dump({**old, **self.seconds}, f)

    def build_seconds(self) -> dict:
        path = os.path.join(self.dir, "build_seconds.json")
        if not os.path.exists(path):
            return {}
        with open(path) as f:
            return json.load(f)

    def _build_artifact(self) -> None:
        if os.path.exists(os.path.join(self.artifact, "manifest.json")):
            return
        import dataclasses

        from repro_torch.core.bm25 import BM25Params
        from repro_torch.core.clustered_index import build_index
        from repro_torch.core.reorder import Arrangement
        from repro_torch.data.synth import Corpus
        from repro_torch.index_io import save_index

        c = self.cfg
        corpus = self.corpus()
        doc_order, range_ends = synth.topic_partition(corpus)
        t0 = time.perf_counter()
        index = build_index(
            Corpus(**{f.name: getattr(corpus, f.name) for f in dataclasses.fields(corpus)}),
            arrangement=Arrangement(doc_order, range_ends, "topical"),
            bits=c["impact_bits"], params=BM25Params(**c["bm25"]))
        self.seconds["build_index"] = time.perf_counter() - t0
        os.makedirs(self.dir, exist_ok=True)
        t0 = time.perf_counter()
        tmp = f"{self.artifact}.tmp-{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        save_index(index, tmp, impact_dtype=c["impact_dtype"], docs_format=c["docs_format"],
                   build_params={"config": c["name"]})
        _publish(tmp, self.artifact)
        self.seconds["save_index"] = time.perf_counter() - t0

    # ---------------------------------------------------------------- pools
    def _pool_dir(self, pool: dict) -> str:
        return os.path.join(self.dir, f"pool-{_key(pool)}")

    def _pool_path(self, pool: dict) -> str:
        return os.path.join(self._pool_dir(pool), "pool.npz")

    def pool(self, pool: dict) -> tuple[np.ndarray, np.ndarray]:
        """The traffic's query pool (made by ``prepare``): [size, max_len]
        int32 term ids (-1 padded) and each query's widest range in blocks of
        ``BLOCK`` postings (the block table's width a server stages for it)."""
        with np.load(self._pool_path(pool)) as z:
            return z["terms"], z["widths"]

    def _make_pool(self, pool: dict) -> None:
        path = self._pool_path(pool)
        if os.path.exists(path):
            return
        t0 = time.perf_counter()
        corpus = self.corpus()
        log = synth.make_query_log(
            corpus, pool["size"], max_len=pool["max_len"], seed=pool["seed"],
            length_dist=tuple(pool["length_dist"]))
        doc_order, range_ends = synth.topic_partition(corpus)
        R, V = len(range_ends), corpus.n_terms
        doc_range = np.zeros(corpus.n_docs, np.int64)
        doc_range[doc_order] = np.repeat(np.arange(R), np.diff(np.r_[0, range_ends]))
        per_doc = np.repeat(doc_range, np.diff(corpus.doc_ptr))
        counts = np.bincount(corpus.doc_terms * R + per_doc, minlength=V * R).reshape(V, R)
        blocks = (counts + ref.BLOCK - 1) // ref.BLOCK
        q = np.clip(log.terms, 0, None)
        widths = np.where((log.terms >= 0)[:, :, None], blocks[q], 0).sum(1).max(1)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.tmp-{os.getpid()}.npz"
        np.savez(tmp, terms=log.terms, widths=widths)
        os.replace(tmp, path)
        self.seconds["pool"] = time.perf_counter() - t0

    # ------------------------------------------------------------ reference
    def _ref_index_path(self, bits: int) -> str:
        return os.path.join(self.dir, f"reference-b{bits}")

    def _ref_path(self, pool: dict, k: int, bits: int | None) -> str:
        bits = self.cfg["impact_bits"] if bits is None else bits
        return os.path.join(self._pool_dir(pool), f"reference-b{bits}-k{k}.npz")

    def reference(self, pool: dict, k: int, bits: int | None = None) -> dict:
        """The reference's trajectory of every pool query at k (``engine.
        trajectories``), at the configuration's impact bits or at ``bits``."""
        c = self.cfg
        path = self._ref_path(pool, k, bits)
        bits = c["impact_bits"] if bits is None else bits
        if not os.path.exists(path):
            terms, _ = self.pool(pool)
            ix_dir = self._ref_index_path(bits)
            if not os.path.exists(ix_dir):
                _in_child(_build_reference_index, self.cfg, self.cache_dir, bits)
            t0 = time.perf_counter()
            imp_size = 1 if c["impact_dtype"] == "int8" else 4
            packed = c["docs_format"] == "packed"
            chunks = [(ix_dir, part, k, imp_size, packed)
                      for part in np.array_split(terms, max(1, 4 * self.workers)) if len(part)]
            if self.workers > 1:
                ctx = multiprocessing.get_context("spawn")
                pool_ = ctx.Pool(self.workers)
                try:
                    parts = pool_.map(_traj_chunk, chunks)
                finally:
                    pool_.close()
                    pool_.join()
            else:
                parts = [_traj_chunk(ch) for ch in chunks]
            out = {key: np.concatenate([p[key] for p in parts]) for key in parts[0]}
            tmp = f"{path}.tmp-{os.getpid()}.npz"
            np.savez(tmp, **out)
            os.replace(tmp, path)
            self.seconds[f"reference_b{bits}_k{k}"] = time.perf_counter() - t0
        with np.load(path) as z:
            return {key: z[key] for key in z.files}
