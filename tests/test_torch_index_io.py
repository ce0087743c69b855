"""The port's index artifacts (``repro_torch.index_io``) against the reference's.

Follows the reference's ``tests/test_index_io.py`` and
``tests/test_golden_artifact.py`` case for case, and adds the crossing
between the packages: the on-disk format is the reference's byte for byte,
so an artifact either package writes loads in the other with an equal
``fingerprint()`` and equal arrays, and engines served from it
(``Engine``/``BatchEngine``/``ShardedEngine.from_artifact``, the port's on
the CPU) equal the reference's on every host observable. Errors raise the
same exception classes. Indexes are built from one seeded corpus by both
packages' numpy builds, which are array for array equal.
"""

from __future__ import annotations

import filecmp
import json
import os

import numpy as np
import pytest

from differential import observe_query
from repro import index_io as ref_io
from repro.core import clustered_index as ref_ci
from repro.core import range_daat as ref_daat
from repro.data.synth import make_corpus, make_query_log
from repro.index_io import corpus_io as ref_corpus_io
from repro.serving import batch_engine as ref_batch
from repro.serving import sharded as ref_sharded
from repro_torch import index_io
from repro_torch.core import clustered_index
from repro_torch.core.range_daat import IMPACT_BIAS, Engine, pack_impacts
from repro_torch.index_io import corpus_io
from repro_torch.index_io.__main__ import main as index_io_cli
from repro_torch.serving.batch_engine import BatchEngine
from repro_torch.serving.sharded import ShardedEngine

DTYPES = ("int32", "int8")
CONFIGS = [(dt, fmt) for dt in DTYPES for fmt in ("int32", "packed")]
SHARD_FIELDS = (
    "docs", "impacts", "blk_start", "blk_len", "blk_maxdoc", "blk_maximp",
    "blk_map", "range_starts", "range_sizes", "bounds_dense",
)
SHARD_SCALARS = ("shard_id", "range_lo", "range_hi", "doc_base", "n_docs", "postings")
K = 10
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "tiny_v1")
GOLDEN_FINGERPRINT = "d731d1fda1b4a01a"


@pytest.fixture(scope="module")
def corpus():
    return make_corpus(n_docs=900, n_terms=700, n_topics=4, mean_doc_len=50, seed=7)


@pytest.fixture(scope="module")
def index(corpus):
    """The port's index; ``ref_index`` is the reference's, the same arrays."""
    return clustered_index.build_index(corpus, n_ranges=6, strategy="clustered")


@pytest.fixture(scope="module")
def ref_index(corpus, index):
    idx = ref_ci.build_index(corpus, n_ranges=6, strategy="clustered")
    assert idx.fingerprint() == index.fingerprint()
    return idx


@pytest.fixture(scope="module")
def queries(corpus):
    log = make_query_log(corpus, n_queries=8, seed=8)
    return [log.terms[i] for i in range(log.n_queries)]


def _port(index, **kw):
    return Engine(index, k=K, device="cpu", **kw)


def _observe_sharded(r) -> dict:
    return {
        "doc_ids": np.asarray(r.doc_ids).tolist(),
        "scores": np.asarray(r.scores).tolist(),
        "shard_postings": np.asarray(r.shard_postings).tolist(),
        "shard_blocks": np.asarray(r.shard_blocks).tolist(),
        "shard_ranges": np.asarray(r.shard_ranges).tolist(),
        "shard_exit_reasons": list(r.shard_exit_reasons),
        "fidelity_bound": int(r.fidelity_bound),
        "exact": bool(r.exact),
    }


def _assert_same_arrays(a, b):
    """Two loaded indexes (either package's), every persisted array."""
    for name in index_io.artifact.INDEX_ARRAYS:
        x = np.asarray(index_io.artifact._index_array(a, name))
        y = np.asarray(ref_io.artifact._index_array(b, name))
        assert x.dtype == y.dtype and np.array_equal(x, y), name
    assert (a.n_docs, a.n_terms, a.quantizer.bits, a.quantizer.scale,
            a.arrangement.strategy) == (b.n_docs, b.n_terms, b.quantizer.bits,
                                        b.quantizer.scale, b.arrangement.strategy)
    assert a.fingerprint() == b.fingerprint()


def _assert_same_tree(a: str, b: str):
    """Two artifact directories hold the same files, byte for byte."""
    cmp = filecmp.dircmp(a, b)
    assert not cmp.left_only and not cmp.right_only, (cmp.left_only, cmp.right_only)
    for name in cmp.common_files:
        assert filecmp.cmp(os.path.join(a, name), os.path.join(b, name),
                           shallow=False), name
    for sub in cmp.common_dirs:
        _assert_same_tree(os.path.join(a, sub), os.path.join(b, sub))


# --------------------------------------------------------------------------
# Artifact round-trip — single device
# --------------------------------------------------------------------------


@pytest.mark.parametrize("impact_dtype", DTYPES)
@pytest.mark.parametrize("mmap", [False, True])
def test_round_trip_bitwise(index, queries, tmp_path, impact_dtype, mmap):
    path = str(tmp_path / f"art_{impact_dtype}")
    index_io.save_index(index, path, impact_dtype=impact_dtype)
    loaded = index_io.load_index(path, mmap=mmap)
    assert loaded.fingerprint() == index.fingerprint()
    assert index_io.read_manifest(path)["fingerprint"] == index.fingerprint()

    ref = _port(index)
    eng = _port(loaded, impact_dtype=impact_dtype)
    for q in queries[:6]:
        assert observe_query(eng, eng.plan(q)) == observe_query(ref, ref.plan(q))


@pytest.mark.parametrize("impact_dtype,docs_format", CONFIGS)
def test_artifacts_cross_packages_both_directions(
    index, ref_index, tmp_path, impact_dtype, docs_format
):
    """The same index saved by either package gives the same files, byte for
    byte, and each package loads the other's to equal arrays."""
    kw = dict(impact_dtype=impact_dtype, docs_format=docs_format,
              build_params={"n_ranges": "6"})
    rpath, ppath = str(tmp_path / "ref"), str(tmp_path / "port")
    ref_io.save_index(ref_index, rpath, **kw)
    index_io.save_index(index, ppath, **kw)
    _assert_same_tree(rpath, ppath)
    for mmap in (False, True):
        _assert_same_arrays(index_io.load_index(rpath, mmap=mmap), ref_index)
        _assert_same_arrays(index, ref_io.load_index(ppath, mmap=mmap))
    assert index_io.validate_artifact(rpath) == [] == ref_io.validate_artifact(ppath)


def test_int8_engine_matches_int32_results(index, queries):
    """Native int8 device storage must not change any retrieval result."""
    e32, e8 = _port(index), _port(index, impact_dtype="int8")
    for q in queries:
        assert observe_query(e8, e8.plan(q)) == observe_query(e32, e32.plan(q))
    for q in queries[:4]:
        a = observe_query(e32, e32.plan(q), budget=512)
        assert a == observe_query(e8, e8.plan(q), budget=512)


def test_pack_impacts_bias_roundtrip(index):
    packed = pack_impacts(index.impacts, "int8")
    assert packed.dtype == np.int8
    assert np.array_equal(
        packed.astype(np.int64) + IMPACT_BIAS, index.impacts.astype(np.int64)
    )
    assert np.array_equal(packed, ref_daat.pack_impacts(index.impacts, "int8"))
    with pytest.raises(ValueError):
        pack_impacts(index.impacts, "int16")


def test_int8_rejected_above_8_bits(corpus, tmp_path):
    idx9 = clustered_index.build_index(corpus, n_ranges=6, strategy="clustered", bits=9)
    with pytest.raises(ValueError, match="bits <= 8"):
        Engine(idx9, impact_dtype="int8", device="cpu")
    with pytest.raises(ValueError, match="bits <= 8"):
        index_io.save_index(idx9, str(tmp_path / "idx9"), impact_dtype="int8")
    assert [d for d in os.listdir(tmp_path) if ".tmp-" in d] == []


# --------------------------------------------------------------------------
# Artifact round-trip — shards
# --------------------------------------------------------------------------


@pytest.mark.parametrize("impact_dtype", DTYPES)
def test_shards_round_trip(index, ref_index, queries, tmp_path, impact_dtype):
    shards = clustered_index.shard_device_index(index, 2)
    path, rpath = str(tmp_path / "shards"), str(tmp_path / "ref_shards")
    kw = dict(impact_dtype=impact_dtype, source_fingerprint=index.fingerprint())
    index_io.save_shards(shards, path, quantizer=index.quantizer, **kw)
    ref_io.save_shards(ref_ci.shard_device_index(ref_index, 2), rpath,
                       quantizer=ref_index.quantizer, **kw)
    _assert_same_tree(path, rpath)

    for loaded in (index_io.load_shards(path), index_io.load_shards(rpath),
                   ref_io.load_shards(path)):
        assert len(loaded) == len(shards)
        for a, b in zip(shards, loaded):
            for f in SHARD_FIELDS:
                assert np.array_equal(getattr(a, f), getattr(b, f)), f
            for f in SHARD_SCALARS:
                assert getattr(a, f) == getattr(b, f), f

    ref = ShardedEngine(_port(index), 2)
    eng = ShardedEngine(_port(index, impact_dtype=impact_dtype), 2,
                        shards=index_io.load_shards(rpath))
    for q in queries[:6]:
        assert (_observe_sharded(eng.traverse(eng.plan(q)))
                == _observe_sharded(ref.traverse(ref.plan(q))))


def test_shards_preloaded_count_checked(index):
    shards = clustered_index.shard_device_index(index, 2)
    with pytest.raises(ValueError, match="shard count"):
        ShardedEngine(_port(index), 3, use_mesh=False, shards=shards)


def test_shards_int8_requires_quantizer(index, tmp_path):
    shards = clustered_index.shard_device_index(index, 2)
    with pytest.raises(ValueError, match="quantizer"):
        index_io.save_shards(shards, str(tmp_path / "s"), impact_dtype="int8")


@pytest.mark.parametrize("impact_dtype,docs_format", [("int8", "int32"),
                                                       ("int8", "packed")])
def test_from_artifact_end_to_end(
    index, queries, tmp_path, impact_dtype, docs_format
):
    """The loading surface on one artifact written by the reference: the
    three port engines equal the reference's, field for field, unbudgeted
    and budgeted."""
    path, spath = str(tmp_path / "idx"), str(tmp_path / "idx.shards2")
    ref_idx = ref_ci.build_index(make_corpus(n_docs=900, n_terms=700, n_topics=4,
                                             mean_doc_len=50, seed=7),
                                 n_ranges=6, strategy="clustered")
    ref_io.save_index(ref_idx, path, impact_dtype=impact_dtype, docs_format=docs_format)
    ref_io.save_shards(
        ref_ci.shard_device_index(ref_idx, 2), spath, impact_dtype="int8",
        quantizer=ref_idx.quantizer, source_fingerprint=ref_idx.fingerprint(),
    )

    eng = Engine.from_artifact(path, k=K, device="cpu")
    ref = ref_daat.Engine.from_artifact(path, k=K)
    assert (eng.impact_dtype, eng.docs_format) == (impact_dtype, docs_format)
    assert (ref.impact_dtype, ref.docs_format) == (impact_dtype, docs_format)
    for q in queries[:4]:
        for budget in (None, 600):
            assert (observe_query(eng, eng.plan(q), budget=budget)
                    == observe_query(ref, ref.plan(q), budget=budget))

    beng = BatchEngine.from_artifact(path, k=K, device="cpu")
    rbeng = ref_batch.BatchEngine.from_artifact(path, k=K)
    for budget in (None, 600):
        got = beng.run_batch(beng.plan_many(queries), budget_postings=budget)
        want = rbeng.run_batch(rbeng.plan_many(queries), budget_postings=budget)
        for g, w in zip(got, want):
            assert [np.asarray(x).tolist() for x in g] == [
                np.asarray(x).tolist() for x in w]

    seng = ShardedEngine.from_artifact(path, 2, shards_path=spath, k=K, device="cpu")
    rseng = ref_sharded.ShardedEngine.from_artifact(
        path, 2, shards_path=spath, use_mesh=False, k=K)
    for q in queries[:4]:
        for budget in (None, 600):
            kw = {} if budget is None else {"budget_postings": budget}
            assert (_observe_sharded(seng.traverse(seng.plan(q), **kw))
                    == _observe_sharded(rseng.traverse(rseng.plan(q), **kw)))


def test_from_artifact_rejects_stale_shards(index, tmp_path):
    """A shard set carved from a different index must not silently serve;
    both packages refuse it with the same error class and message."""
    other = clustered_index.build_index(
        make_corpus(n_docs=400, n_terms=300, n_topics=4, seed=9), n_ranges=4,
        strategy="clustered",
    )
    opath = str(tmp_path / "other")
    index_io.save_index(other, opath)
    spath = str(tmp_path / "stale.shards")
    index_io.save_shards(
        clustered_index.shard_device_index(index, 2), spath,
        quantizer=index.quantizer, source_fingerprint=index.fingerprint(),
    )
    upath = str(tmp_path / "unverifiable.shards")
    index_io.save_shards(clustered_index.shard_device_index(index, 2), upath,
                         quantizer=index.quantizer)
    for shards_path, match in ((spath, "carved from"), (upath, "source_fingerprint")):
        with pytest.raises(index_io.ArtifactError, match=match) as got:
            ShardedEngine.from_artifact(opath, 2, shards_path=shards_path,
                                        device="cpu")
        with pytest.raises(ref_io.ArtifactError, match=match) as want:
            ref_sharded.ShardedEngine.from_artifact(opath, 2, shards_path=shards_path,
                                                    use_mesh=False)
        assert str(got.value) == str(want.value)


# --------------------------------------------------------------------------
# device_bytes accounting
# --------------------------------------------------------------------------


@pytest.mark.parametrize("impact_dtype", DTYPES)
def test_device_bytes_match_uploaded_buffers(index, impact_dtype):
    eng = _port(index, impact_dtype=impact_dtype)
    dev = index.space_report(impact_dtype)["device_bytes"]
    fields = [
        n for n in eng.dix._fields
        if not n.startswith("pack_") and getattr(eng.dix, n) is not None
    ]
    for name in fields:
        assert dev[name] == getattr(eng.dix, name).nbytes, name
    assert dev["postings"] == dev["docs"] + dev["impacts"]
    assert dev["total"] == sum(dev[n] for n in fields)


def test_int8_halves_postings_hbm(index):
    d32 = index.space_report("int32")["device_bytes"]
    d8 = index.space_report("int8")["device_bytes"]
    assert d32["impacts"] == 4 * d8["impacts"]
    assert d32["postings"] / d8["postings"] >= 1.5
    assert d8["total"] < d32["total"]
    with pytest.raises(ValueError):
        index.device_bytes("float16")


# --------------------------------------------------------------------------
# Error paths: corruption, versioning, overwrite — the reference's classes
# --------------------------------------------------------------------------


@pytest.fixture()
def artifact_path(index, tmp_path):
    path = str(tmp_path / "art")
    index_io.save_index(index, path, impact_dtype="int8")
    return path


def _both_raise(path, exc_name: str, match: str, load="load_index"):
    """The port and the reference refuse ``path`` with the same class."""
    for pkg in (index_io, ref_io):
        with pytest.raises(getattr(pkg, exc_name), match=match):
            getattr(pkg, load)(path)


def test_corrupt_manifest_raises(artifact_path):
    with open(os.path.join(artifact_path, "manifest.json"), "w") as f:
        f.write("{ not json")
    _both_raise(artifact_path, "CorruptArtifactError", "unparseable")
    assert index_io.validate_artifact(artifact_path) != []


def test_version_mismatch_raises(artifact_path):
    mpath = os.path.join(artifact_path, "manifest.json")
    with open(mpath) as f:
        manifest = json.load(f)
    manifest["format_version"] = index_io.FORMAT_VERSION + 1
    with open(mpath, "w") as f:
        json.dump(manifest, f)
    _both_raise(artifact_path, "VersionMismatchError", "format_version")


def test_missing_array_raises(artifact_path):
    os.remove(os.path.join(artifact_path, "arrays", "docs.npy"))
    _both_raise(artifact_path, "CorruptArtifactError", "docs")


def test_tampered_array_fails_fingerprint(artifact_path):
    fpath = os.path.join(artifact_path, "arrays", "docs.npy")
    docs = np.load(fpath).copy()
    docs[0] += 1
    np.save(fpath, docs)
    _both_raise(artifact_path, "CorruptArtifactError", "fingerprint")
    assert any("sha256" in p for p in index_io.validate_artifact(artifact_path))
    assert index_io.validate_artifact(artifact_path) == ref_io.validate_artifact(
        artifact_path)


def test_wrong_kind_raises(index, artifact_path, tmp_path):
    spath = str(tmp_path / "shards")
    index_io.save_shards(clustered_index.shard_device_index(index, 2), spath,
                         quantizer=index.quantizer)
    _both_raise(spath, "CorruptArtifactError", "kind")
    _both_raise(artifact_path, "CorruptArtifactError", "kind", load="load_shards")


def test_concurrent_overwrite_readers_survive_publish_race(index, tmp_path):
    """The rename-aside overwrite admits a briefly-absent path: readers
    retry once on ENOENT instead of crashing on a healthy artifact. One
    writer republishes in a loop against concurrent readers."""
    import threading

    path = str(tmp_path / "live")
    index_io.save_index(index, path)
    stop = threading.Event()
    errors: list = []

    def writer():
        try:
            for _ in range(12):
                index_io.save_index(index, path, overwrite=True)
        except Exception as e:  # noqa: BLE001 — surfaced via `errors`
            errors.append(("writer", repr(e)))
        finally:
            stop.set()

    def reader():
        try:
            while not stop.is_set():
                manifest = index_io.read_manifest(path)
                assert manifest["fingerprint"] == index.fingerprint()
                loaded = index_io.load_index(path, mmap=True)
                assert loaded.fingerprint() == index.fingerprint()
        except Exception as e:  # noqa: BLE001 — surfaced via `errors`
            errors.append(("reader", repr(e)))

    threads = [threading.Thread(target=writer)] + [
        threading.Thread(target=reader) for _ in range(3)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    assert index_io.validate_artifact(path) == []


def test_overwrite_guard(index, artifact_path):
    with pytest.raises(index_io.ArtifactError, match="overwrite"):
        index_io.save_index(index, artifact_path)
    index_io.save_index(index, artifact_path, overwrite=True)
    assert index_io.validate_artifact(artifact_path) == []
    leftovers = [
        d for d in os.listdir(os.path.dirname(artifact_path)) if ".tmp-" in d
    ]
    assert leftovers == []


# --------------------------------------------------------------------------
# Cached build via the artifact format
# --------------------------------------------------------------------------


def test_build_index_cached_uses_artifacts(tmp_path):
    """A miss builds and saves, a hit loads; the entry is the one the
    reference's ``build_index_cached`` would write and read, same name and
    same bytes."""
    c = make_corpus(n_docs=400, n_terms=300, n_topics=4, seed=3)
    cache, ref_cache = str(tmp_path / "cache"), str(tmp_path / "ref_cache")
    kw = dict(n_ranges=4, strategy="clustered")
    i1 = clustered_index.build_index_cached(c, cache_dir=cache, **kw)
    entries = os.listdir(cache)
    assert len(entries) == 1 and entries[0].startswith("index_")
    assert index_io.validate_artifact(os.path.join(cache, entries[0])) == []
    i2 = clustered_index.build_index_cached(c, cache_dir=cache, **kw)
    assert i2.fingerprint() == i1.fingerprint()
    assert os.listdir(cache) == entries
    ref_ci.build_index_cached(c, cache_dir=ref_cache, **kw)
    assert os.listdir(ref_cache) == entries
    _assert_same_tree(cache, ref_cache)
    hit = ref_ci.build_index_cached(c, cache_dir=cache, **kw)
    assert hit.fingerprint() == i1.fingerprint()


def test_build_index_cached_self_heals_old_format(tmp_path):
    """A format-version bump is a cache miss, not a permanent crash."""
    c = make_corpus(n_docs=400, n_terms=300, n_topics=4, seed=3)
    cache = str(tmp_path / "cache")
    kw = dict(n_ranges=4, strategy="clustered")
    i1 = clustered_index.build_index_cached(c, cache_dir=cache, **kw)
    entry = os.path.join(cache, os.listdir(cache)[0])
    mpath = os.path.join(entry, "manifest.json")
    with open(mpath) as f:
        manifest = json.load(f)
    manifest["format_version"] = index_io.FORMAT_VERSION - 1
    with open(mpath, "w") as f:
        json.dump(manifest, f)

    i2 = clustered_index.build_index_cached(c, cache_dir=cache, **kw)
    assert i2.fingerprint() == i1.fingerprint()
    assert index_io.validate_artifact(entry) == []
    with open(mpath, "w") as f:
        f.write("broken")
    with pytest.raises(index_io.CorruptArtifactError):
        clustered_index.build_index_cached(c, cache_dir=cache, **kw)


# --------------------------------------------------------------------------
# Corpus reader registry
# --------------------------------------------------------------------------


def _same_corpus(a, b):
    assert a.fingerprint() == b.fingerprint()
    assert (a.n_docs, a.n_terms, a.n_topics) == (b.n_docs, b.n_terms, b.n_topics)
    assert np.array_equal(a.doc_topic, b.doc_topic)


def test_tsv_reader_round_trip(tmp_path):
    src = tmp_path / "coll.tsv"
    src.write_text(
        "d0\tthe quick brown fox\n"
        "d1\tquick quick fox jumps\n"
        "\n"
        "d2\tlazy dog sleeps\n"
    )
    c = corpus_io.read_tsv(str(src))
    assert c.n_docs == 3 and c.n_terms == 8
    t, tf = c.doc_slice(1)
    vocab = {"brown": 0, "dog": 1, "fox": 2, "jumps": 3, "lazy": 4,
             "quick": 5, "sleeps": 6, "the": 7}
    assert dict(zip(t.tolist(), tf.tolist())) == {
        vocab["quick"]: 2, vocab["fox"]: 1, vocab["jumps"]: 1
    }
    _same_corpus(corpus_io.read_corpus("tsv", str(src)), c)
    _same_corpus(c, ref_corpus_io.read_tsv(str(src)))
    assert corpus_io.read_tsv(str(src), max_docs=2).n_docs == 2


def test_jsonl_reader_text_and_terms(tmp_path):
    text_src = tmp_path / "text.jsonl"
    text_src.write_text(
        '{"id": "a", "text": "alpha beta"}\n{"id": "b", "text": "beta gamma"}\n'
    )
    c = corpus_io.read_jsonl(str(text_src))
    assert c.n_docs == 2 and c.n_terms == 3
    _same_corpus(c, ref_corpus_io.read_jsonl(str(text_src)))

    term_src = tmp_path / "terms.jsonl"
    term_src.write_text('{"terms": [0, 2], "tfs": [3, 1]}\n{"terms": [1]}\n')
    c = corpus_io.read_jsonl(str(term_src))
    assert c.n_docs == 2 and c.n_terms == 3
    t, tf = c.doc_slice(0)
    assert t.tolist() == [0, 2] and tf.tolist() == [3, 1]

    mixed = tmp_path / "mixed.jsonl"
    mixed.write_text('{"text": "a"}\n{"terms": [0]}\n')
    with pytest.raises(ValueError, match="mixes"):
        corpus_io.read_jsonl(str(mixed))


def test_tsv_reader_rejects_untabbed_line(tmp_path):
    src = tmp_path / "bad.tsv"
    src.write_text("d0\tfine text\nd1 missing tab separator\n")
    with pytest.raises(ValueError, match="no tab"):
        corpus_io.read_tsv(str(src))


def test_synth_reader_matches_the_references():
    kw = dict(n_docs=300, n_terms=200, n_topics=3, seed=5)
    _same_corpus(corpus_io.read_corpus("synth", None, **kw),
                 ref_corpus_io.read_corpus("synth", None, **kw))


def test_ingested_corpus_builds_and_serves(tmp_path):
    """A reader's output drives the full pipeline."""
    rng = np.random.default_rng(0)
    words = [f"w{i}" for i in range(50)]
    lines = [f"doc{d}\t{' '.join(rng.choice(words, size=rng.integers(5, 15)))}"
             for d in range(60)]
    src = tmp_path / "c.tsv"
    src.write_text("\n".join(lines) + "\n")

    c = corpus_io.read_corpus("tsv", str(src))
    idx = clustered_index.build_index(c, n_ranges=2, strategy="clustered")
    eng = Engine(idx, k=5, device="cpu")
    res = eng.traverse(eng.plan(np.asarray([0, 1, 2], np.int32)))
    assert (res.state.ids >= 0).any()


def test_gated_readers_clean_without_optional_deps():
    avail = corpus_io.available_readers()
    assert avail == ref_corpus_io.available_readers()
    assert {"synth", "tsv", "jsonl", "ciff", "ir_datasets"} <= set(avail)
    for name in ("ciff", "ir_datasets"):
        if avail[name]:  # pragma: no cover — extra installed in this env
            pytest.skip(f"optional dep for {name} installed")
        with pytest.raises(corpus_io.MissingDependencyError, match="repro\\[corpus\\]"):
            corpus_io.get_reader(name)
    with pytest.raises(KeyError, match="unknown corpus reader"):
        corpus_io.get_reader("nope")


# --------------------------------------------------------------------------
# CLI
# --------------------------------------------------------------------------


def test_cli_build_inspect_validate(tmp_path, capsys):
    out = str(tmp_path / "idx")
    rc = index_io_cli([
        "build", "--out", out, "--reader", "synth",
        "--n-docs", "400", "--n-terms", "300", "--n-topics", "4",
        "--n-ranges", "4", "--impact-dtype", "int8", "--shards", "2",
    ])
    assert rc == 0
    assert index_io_cli(["inspect", out]) == 0
    assert "int8" in capsys.readouterr().out
    assert index_io_cli(["validate", out]) == 0
    assert index_io_cli(["validate", out + ".shards2"]) == 0
    assert ref_io.validate_artifact(out) == []
    assert ref_io.validate_artifact(out + ".shards2") == []

    packed = str(tmp_path / "idx.packed")
    assert index_io_cli(["repack", out, "--out", packed]) == 0
    m = index_io.read_manifest(packed)
    assert m["docs_format"] == "packed" and m["impact_dtype"] == "int8"
    assert m["fingerprint"] == index_io.read_manifest(out)["fingerprint"]
    assert index_io_cli(["validate", packed]) == 0

    with open(os.path.join(out, "manifest.json"), "w") as f:
        f.write("broken")
    assert index_io_cli(["validate", out]) == 1
    assert index_io_cli(["inspect", out]) == 1


def test_cli_rejects_int8_above_8_bits(tmp_path, capsys):
    rc = index_io_cli([
        "build", "--out", str(tmp_path / "x"), "--bits", "9",
        "--impact-dtype", "int8", "--n-docs", "100", "--n-terms", "80",
    ])
    assert rc == 1
    assert "--bits <= 8" in capsys.readouterr().err


# --------------------------------------------------------------------------
# The golden v1 artifact (the reference's tests/test_golden_artifact.py)
# --------------------------------------------------------------------------


def _golden_index():
    import dataclasses

    corpus = make_corpus(n_docs=80, n_terms=60, n_topics=3, mean_doc_len=20, seed=123)
    idx = clustered_index.build_index(corpus, n_ranges=3, strategy="clustered",
                                      bits=8, seed=0)
    return dataclasses.replace(idx, stats=None)  # golden predates stats


def test_golden_v1_loads_bitwise():
    manifest = index_io.read_manifest(GOLDEN)
    assert manifest["format_version"] == 1 < index_io.FORMAT_VERSION
    assert manifest["fingerprint"] == GOLDEN_FINGERPRINT
    assert index_io.validate_artifact(GOLDEN) == []

    loaded = index_io.load_index(GOLDEN)
    assert loaded.fingerprint() == GOLDEN_FINGERPRINT
    assert loaded.stats is None
    _assert_same_arrays(loaded, ref_io.load_index(GOLDEN))
    rebuilt = _golden_index()
    assert rebuilt.fingerprint() == GOLDEN_FINGERPRINT
    for name in ("docs", "impacts", "blk_start", "blk_len", "bounds_dense"):
        np.testing.assert_array_equal(getattr(loaded, name), getattr(rebuilt, name))


def test_golden_v1_still_refuses_extension():
    loaded = index_io.load_index(GOLDEN)
    delta = make_corpus(n_docs=10, n_terms=60, n_topics=3, mean_doc_len=20, seed=321)
    with pytest.raises(ValueError, match="no frozen collection stats"):
        clustered_index.extend_index(loaded, delta)


def test_unknown_format_version_refused(tmp_path):
    out = tmp_path / "future"
    index_io.save_index(_golden_index(), str(out))
    mpath = out / "manifest.json"
    manifest = json.loads(mpath.read_text())
    manifest["format_version"] = index_io.FORMAT_VERSION + 1
    mpath.write_text(json.dumps(manifest))
    for pkg in (index_io, ref_io):
        with pytest.raises(pkg.VersionMismatchError):
            pkg.read_manifest(str(out))


def test_repack_golden_equals_from_scratch_packed(tmp_path):
    """v1 -> packed-v2 migration is bitwise the from-scratch packed save, and
    equal to the reference's repack of the same golden."""
    repacked, scratch = str(tmp_path / "repacked"), str(tmp_path / "scratch")
    assert index_io_cli(["repack", GOLDEN, "--out", repacked]) == 0
    index_io.save_index(_golden_index(), scratch, impact_dtype="int8",
                        docs_format="packed")

    mr, ms = index_io.read_manifest(repacked), index_io.read_manifest(scratch)
    assert mr["format_version"] == index_io.FORMAT_VERSION
    assert mr["docs_format"] == "packed" and "docs" not in mr["arrays"]
    assert mr["fingerprint"] == GOLDEN_FINGERPRINT
    assert mr["arrays"].keys() == ms["arrays"].keys()
    for name in mr["arrays"]:
        assert mr["arrays"][name]["sha256"] == ms["arrays"][name]["sha256"], name
    assert mr["build_params"]["repacked_from"] == os.path.abspath(GOLDEN)

    ref_repacked = str(tmp_path / "ref_repacked")
    ref_io.repack(GOLDEN, ref_repacked)
    _assert_same_tree(repacked, ref_repacked)
    assert index_io.validate_artifact(repacked) == []
    round_tripped = index_io.load_index(repacked)
    assert round_tripped.fingerprint() == GOLDEN_FINGERPRINT
    np.testing.assert_array_equal(round_tripped.docs, index_io.load_index(GOLDEN).docs)
