"""The port's incremental index artifacts against the reference's.

Follows the reference's ``tests/test_incremental.py``: ``extend_index``
equals a fresh build bitwise (and the reference's ``extend_index``), delta
chains round-trip and ``compact`` in both packages to the same files, an
engine from a chain head serves bitwise, a crashed append, mis-chained
deltas, a pre-incremental artifact and the topology journal's torn tail
behave as there, and the CLI's append/compact/log; the control plane's
journal replay (cuts and ledger reconstructed, records from before the
last reshard skipped, a foreign journal refused, a chain head's journal),
a journal written by either package's plane replayed by the other's, and
the replay across a process boundary (the reference's subprocess case,
JAX-free and on one device: ``use_mesh=False``).
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from differential import observe_query
from repro import index_io as ref_io
from repro.control import ControlPlane as RefPlane
from repro.control import TopologyJournal as RefJournal
from repro.core import clustered_index as ref_ci
from repro.data.synth import concat_corpora as ref_concat
from repro.data.synth import make_corpus, make_query_log
from repro_torch import index_io
from repro_torch.control import JOURNAL_NAME, ControlPlane, TopologyJournal
from repro_torch.core.clustered_index import (
    apply_delta,
    build_index,
    extend_index,
    extended_arrangement,
    plan_delta,
)
from repro_torch.core.range_daat import Engine
from repro_torch.data.synth import concat_corpora
from repro_torch.index_io.__main__ import main as cli
from repro_torch.serving import BucketSpec

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

INDEX_FIELDS = (
    "ptr", "docs", "impacts",
    "blk_start", "blk_len", "blk_maxdoc", "blk_maximp", "blk_term", "blk_range",
    "tr_ptr", "tr_range", "tr_blk_start", "tr_blk_end", "tr_bound",
    "term_bound", "bounds_dense",
)


@pytest.fixture(scope="module")
def base_corpus():
    return make_corpus(n_docs=900, n_terms=700, n_topics=4, mean_doc_len=50, seed=7)


@pytest.fixture(scope="module")
def deltas():
    return [
        make_corpus(n_docs=150, n_terms=700, n_topics=4, mean_doc_len=50, seed=21),
        make_corpus(n_docs=90, n_terms=700, n_topics=4, mean_doc_len=50, seed=22),
        make_corpus(n_docs=60, n_terms=700, n_topics=4, mean_doc_len=50, seed=23),
    ]


@pytest.fixture(scope="module")
def base_index(base_corpus):
    return build_index(base_corpus, n_ranges=6, strategy="clustered")


def _assert_index_equal(a, b):
    for f in INDEX_FIELDS:
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    np.testing.assert_array_equal(a.arrangement.doc_order, b.arrangement.doc_order)
    np.testing.assert_array_equal(a.range_ends, b.range_ends)
    assert (a.n_docs, a.n_terms) == (b.n_docs, b.n_terms)
    assert a.fingerprint() == b.fingerprint()


def _assert_same_tree(a: str, b: str, skip=("build_params",)):
    """Two artifacts' array files byte for byte, manifests equal but for
    ``skip`` keys and relative parent paths."""
    for root, _, files in os.walk(a):
        for name in files:
            pa = os.path.join(root, name)
            pb = os.path.join(b, os.path.relpath(pa, a))
            if name == "manifest.json":
                ma, mb = json.load(open(pa)), json.load(open(pb))
                for key in skip:
                    ma.pop(key, None), mb.pop(key, None)
                assert ma == mb, pa
            else:
                assert open(pa, "rb").read() == open(pb, "rb").read(), pa


# --------------------------------------------------------------------------
# Core: extend_index == fresh build, bitwise
# --------------------------------------------------------------------------


def test_concat_corpora_is_the_references(base_corpus, deltas):
    got = concat_corpora(base_corpus, deltas[0])
    want = ref_concat(base_corpus, deltas[0])
    for f in ("doc_ptr", "doc_terms", "doc_tfs", "doc_topic"):
        x, y = getattr(got, f), getattr(want, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    assert (got.n_docs, got.n_terms, got.n_topics) == (want.n_docs, want.n_terms,
                                                       want.n_topics)
    with pytest.raises(ValueError, match="vocabulary"):
        concat_corpora(base_corpus, make_corpus(n_docs=20, n_terms=300, seed=1))


def test_extend_index_matches_fresh_build_bitwise(base_corpus, base_index, deltas):
    """Append x2 in memory == one from-scratch build on the concatenated
    corpus at the extended arrangement / shared quantizer / frozen stats ==
    the reference's extension."""
    ext1 = extend_index(base_index, deltas[0], n_ranges=2, seed=5)
    ext2 = extend_index(ext1, deltas[1], n_ranges=1, seed=6)
    assert ext2.n_docs == base_index.n_docs + 240
    assert ext2.n_ranges == base_index.n_ranges + 3
    assert ext2.stats is base_index.stats

    cat = concat_corpora(concat_corpora(base_corpus, deltas[0]), deltas[1])
    fresh = build_index(cat, arrangement=ext2.arrangement, quantizer=base_index.quantizer,
                        stats=base_index.stats, params=base_index.bm25)
    _assert_index_equal(ext2, fresh)

    ref_base = ref_ci.build_index(base_corpus, n_ranges=6, strategy="clustered")
    ref_ext = ref_ci.extend_index(
        ref_ci.extend_index(ref_base, deltas[0], n_ranges=2, seed=5),
        deltas[1], n_ranges=1, seed=6)
    _assert_index_equal(ext2, ref_ext)
    arr = extended_arrangement(base_index.arrangement, np.arange(3), np.asarray([3]))
    ref_arr = ref_ci.extended_arrangement(ref_base.arrangement, np.arange(3),
                                          np.asarray([3]))
    assert np.array_equal(arr.doc_order, ref_arr.doc_order)
    assert np.array_equal(arr.range_ends, ref_arr.range_ends)


def test_plan_delta_is_the_references(base_corpus, base_index, deltas):
    got = plan_delta(base_index, deltas[0], n_ranges=2, seed=5)
    ref_base = ref_ci.build_index(base_corpus, n_ranges=6, strategy="clustered")
    want = ref_ci.plan_delta(ref_base, deltas[0], n_ranges=2, seed=5)
    for f in dataclasses.fields(want):
        x, y = getattr(got, f.name), getattr(want, f.name)
        if isinstance(y, np.ndarray):
            assert x.dtype == y.dtype and np.array_equal(x, y), f.name
        else:
            assert x == y, f.name


def test_extended_index_serves_and_finds_new_docs(base_index, deltas):
    ext = extend_index(base_index, deltas[0], n_ranges=2, seed=5)
    eng = Engine(ext, k=10, device="cpu")
    log = make_query_log(deltas[0], n_queries=8, seed=30)
    hit_new = 0
    for i in range(log.n_queries):
        ids, _ = eng.topk_docs(eng.traverse(eng.plan(log.terms[i])).state)
        assert ids.size > 0
        hit_new += int((ids >= base_index.n_docs).sum())
    assert hit_new > 0


def test_extend_validations(base_corpus, base_index, deltas):
    with pytest.raises(ValueError, match="vocabulary|terms"):
        extend_index(base_index, make_corpus(n_docs=50, n_terms=300, n_topics=2, seed=1))
    empty = dataclasses.replace(
        deltas[0], n_docs=0, doc_ptr=np.zeros(1, np.int64),
        doc_terms=np.empty(0, np.int32), doc_tfs=np.empty(0, np.int32),
        doc_topic=np.empty(0, np.int32),
    )
    with pytest.raises(ValueError, match="empty"):
        extend_index(base_index, empty)
    statless = dataclasses.replace(base_index, stats=None)
    with pytest.raises(ValueError, match="stats"):
        extend_index(statless, deltas[0])
    other = build_index(base_corpus, n_ranges=4, strategy="clustered", seed=9)
    with pytest.raises(ValueError, match="planned against"):
        apply_delta(base_index, plan_delta(other, deltas[0]))


# --------------------------------------------------------------------------
# Artifacts: chain round-trip, compaction, crash recovery
# --------------------------------------------------------------------------


@pytest.mark.parametrize("impact_dtype", ["int32", "int8"])
@pytest.mark.parametrize("mmap", [False, True])
def test_chain_roundtrip_and_compact_bitwise(
    base_corpus, base_index, deltas, tmp_path, impact_dtype, mmap
):
    """append xN -> load_chain == compact == fresh build, bitwise; the
    reference loads the port's chain and its compaction to the same index."""
    base = str(tmp_path / "base")
    index_io.save_index(base_index, base, impact_dtype=impact_dtype)
    parent, cat = base, base_corpus
    for i, d in enumerate(deltas):
        head = str(tmp_path / f"delta{i}")
        ext = index_io.append_index(parent, d, head, n_ranges=1 + i % 2, seed=40 + i)
        cat = concat_corpora(cat, d)
        parent = head

    manifest = index_io.read_manifest(parent)
    assert manifest["chain_length"] == len(deltas)
    assert manifest["impact_dtype"] == impact_dtype
    assert manifest["n_docs_total"] == cat.n_docs

    loaded = index_io.load_index(parent, mmap=mmap)
    assert loaded.fingerprint() == ext.fingerprint() == manifest["fingerprint"]

    out = str(tmp_path / "compacted")
    index_io.compact(parent, out)
    assert index_io.read_manifest(out)["impact_dtype"] == impact_dtype
    compacted = index_io.load_index(out, mmap=mmap)

    fresh = build_index(cat, arrangement=ext.arrangement, quantizer=base_index.quantizer,
                        stats=base_index.stats, params=base_index.bm25)
    _assert_index_equal(loaded, fresh)
    _assert_index_equal(compacted, fresh)
    for idx in (loaded, compacted):
        assert idx.stats is not None
        assert idx.stats.n_docs == base_index.stats.n_docs
        assert idx.stats.avg_doc_len == base_index.stats.avg_doc_len
        np.testing.assert_array_equal(idx.stats.df, base_index.stats.df)
    assert index_io.validate_artifact(parent) == []
    assert index_io.validate_artifact(out) == []
    _assert_index_equal(ref_io.load_index(parent, mmap=mmap), fresh)
    _assert_index_equal(ref_io.load_index(out, mmap=mmap), fresh)


def test_chains_cross_packages_both_directions(base_index, deltas, tmp_path):
    """The same append written by either package: equal delta files, and
    each package loads and compacts the other's chain."""
    port_dir, ref_dir = tmp_path / "port", tmp_path / "ref"
    for d, io in ((port_dir, index_io), (ref_dir, ref_io)):
        io.save_index(base_index, str(d / "base"), impact_dtype="int8")
        io.append_index(str(d / "base"), deltas[0], str(d / "d1"), n_ranges=2, seed=5)
        io.append_index(str(d / "d1"), deltas[1], str(d / "d2"), seed=6)
    for name in ("base", "d1", "d2"):
        _assert_same_tree(str(port_dir / name), str(ref_dir / name))
    want = index_io.load_chain(str(port_dir / "d2"))
    _assert_index_equal(index_io.load_chain(str(ref_dir / "d2")), want)
    _assert_index_equal(ref_io.load_chain(str(port_dir / "d2")), want)
    index_io.compact(str(ref_dir / "d2"), str(tmp_path / "pc"))
    ref_io.compact(str(port_dir / "d2"), str(tmp_path / "rc"))
    _assert_same_tree(str(tmp_path / "pc"), str(tmp_path / "rc"))
    assert [m["kind"] for _, m in index_io.iter_chain(str(ref_dir / "d2"))] == [
        "index_delta", "index_delta", "clustered_index"]


def test_engine_from_chain_head_serves_bitwise(base_index, deltas, tmp_path):
    base, head = str(tmp_path / "base"), str(tmp_path / "head")
    index_io.save_index(base_index, base, impact_dtype="int8")
    ext = index_io.append_index(base, deltas[0], head, n_ranges=2, seed=5)

    eng = Engine.from_artifact(head, k=10, device="cpu")
    assert eng.impact_dtype == "int8"
    ref = Engine(ext, k=10, device="cpu")
    log = make_query_log(deltas[0], n_queries=6, seed=31)
    for i in range(log.n_queries):
        for budget in (None, 400):
            assert (observe_query(eng, eng.plan(log.terms[i]), budget=budget)
                    == observe_query(ref, ref.plan(log.terms[i]), budget=budget))


def test_crash_mid_append_staging_ignored_and_cleaned(base_index, deltas, tmp_path):
    base, head = str(tmp_path / "base"), str(tmp_path / "head")
    index_io.save_index(base_index, base)
    index_io.append_index(base, deltas[0], head)

    stale = str(tmp_path / "head.tmp-CRASHED")
    os.makedirs(os.path.join(stale, "arrays"))
    with open(os.path.join(stale, "arrays", "docs.npy"), "w") as f:
        f.write("partial garbage")
    assert index_io.load_index(head).n_docs == base_index.n_docs + deltas[0].n_docs
    assert index_io.validate_artifact(head) == []

    removed = index_io.clean_stale_staging(head, max_age_s=0.0)
    assert "head.tmp-CRASHED" in removed
    assert not os.path.exists(stale)
    fresh = str(tmp_path / "head.tmp-LIVE")
    os.makedirs(fresh)
    assert index_io.clean_stale_staging(head) == []
    assert os.path.isdir(fresh)

    index_io.append_index(base, deltas[0], head, overwrite=True)
    assert index_io.validate_artifact(head) == []


def test_mis_chained_and_corrupt_deltas_refused(base_corpus, base_index, deltas, tmp_path):
    base, other = str(tmp_path / "base"), str(tmp_path / "other")
    index_io.save_index(base_index, base)
    index_io.save_index(build_index(base_corpus, n_ranges=4, strategy="clustered",
                                    seed=9), other)

    delta = plan_delta(base_index, deltas[0])
    with pytest.raises(index_io.ArtifactError, match="planned against"):
        index_io.save_delta(delta, str(tmp_path / "d"), other, "whatever")

    head = str(tmp_path / "head")
    index_io.append_index(base, deltas[0], head)

    mpath = os.path.join(head, "manifest.json")
    with open(mpath) as f:
        manifest = json.load(f)
    good_parent = manifest["parent"]
    manifest["parent"] = "../nowhere"
    with open(mpath, "w") as f:
        json.dump(manifest, f)
    for io in (index_io, ref_io):
        with pytest.raises(io.CorruptArtifactError):
            io.load_index(head)
    assert index_io.validate_artifact(head) != []

    manifest["parent"] = good_parent
    manifest["fingerprint"] = "0" * 16
    with open(mpath, "w") as f:
        json.dump(manifest, f)
    for io in (index_io, ref_io):
        with pytest.raises(io.CorruptArtifactError, match="fingerprint"):
            io.load_index(head)


def test_pre_incremental_artifact_cannot_extend(base_index, deltas, tmp_path):
    base = str(tmp_path / "base")
    index_io.save_index(base_index, base)
    mpath = os.path.join(base, "manifest.json")
    with open(mpath) as f:
        saved = json.load(f)

    for drop in ("collection", "stats_df"):
        manifest = json.loads(json.dumps(saved))
        if drop == "collection":
            del manifest["collection"]
        else:
            del manifest["arrays"]["stats_df"]
        with open(mpath, "w") as f:
            json.dump(manifest, f)
        with pytest.raises(index_io.CorruptArtifactError, match="stats"):
            index_io.load_index(base)

    manifest = json.loads(json.dumps(saved))
    del manifest["collection"]
    del manifest["arrays"]["stats_df"]
    with open(mpath, "w") as f:
        json.dump(manifest, f)
    loaded = index_io.load_index(base)
    assert loaded.stats is None
    assert loaded.fingerprint() == base_index.fingerprint()
    with pytest.raises(ValueError, match="stats"):
        index_io.append_index(base, deltas[0], str(tmp_path / "d"))


# --------------------------------------------------------------------------
# Topology journal
# --------------------------------------------------------------------------


def test_topology_journal_records_and_torn_tail(tmp_path):
    j = TopologyJournal(str(tmp_path / JOURNAL_NAME))
    assert j.records() == [] and not j.exists
    j.append({"kind": "health", "event": "down", "shard": 1, "replica": None})
    j.append({"kind": "reshard", "cuts": [0, 2, 6]})
    recs = j.records()
    assert [r["seq"] for r in recs] == [0, 1]
    assert recs[1]["cuts"] == [0, 2, 6]
    assert RefJournal(j.path).records() == recs
    with open(j.path, "a") as f:
        f.write('{"kind": "resha')
    assert len(j.records()) == 2
    assert j.next_seq() == 2
    with open(j.path, "a") as f:
        f.write('rd"\n{"kind": "health", "event": "up", "shard": 1}\n')
    with pytest.raises(ValueError, match="corrupt"):
        j.records()


def test_journal_append_after_torn_tail_truncates_not_concatenates(tmp_path):
    j = TopologyJournal(str(tmp_path / JOURNAL_NAME))
    j.append({"kind": "health", "event": "down", "shard": 0, "replica": None})
    with open(j.path, "a") as f:
        f.write('{"kind": "resha')
    j2 = TopologyJournal(j.path)
    j2.append({"kind": "reshard", "cuts": [0, 2, 4]})
    j2.append({"kind": "health", "event": "up", "shard": 0, "replica": None})
    recs = j2.records()
    assert [r["kind"] for r in recs] == ["health", "reshard", "health"]
    assert [r["seq"] for r in recs] == [0, 1, 2]
    assert recs[1]["cuts"] == [0, 2, 4]
    assert RefJournal(j.path).records() == recs


# --------------------------------------------------------------------------
# CLI
# --------------------------------------------------------------------------


def test_cli_append_compact_log(tmp_path, capsys):
    base, head = str(tmp_path / "idx"), str(tmp_path / "idx.d1")
    assert cli([
        "build", "--out", base, "--reader", "synth",
        "--n-docs", "400", "--n-terms", "300", "--n-topics", "4",
        "--n-ranges", "4", "--impact-dtype", "int8",
    ]) == 0
    assert cli([
        "append", "--parent", base, "--out", head, "--reader", "synth",
        "--n-docs", "80", "--n-terms", "300", "--n-topics", "4", "--seed", "11",
    ]) == 0
    assert "chain length 1" in capsys.readouterr().out
    TopologyJournal(os.path.join(head, JOURNAL_NAME)).append(
        {"fingerprint": index_io.read_manifest(head)["fingerprint"],
         "kind": "reshard", "cuts": [0, 2, 5], "reason": "operator"})
    assert cli(["log", head]) == 0
    out = capsys.readouterr().out
    assert "clustered_index base" in out and "delta +80 docs" in out
    assert "reshard" in out
    assert cli(["validate", head]) == 0
    assert cli(["inspect", head]) == 0
    compacted = str(tmp_path / "idx.compact")
    assert cli(["compact", head, "--out", compacted]) == 0
    assert cli(["validate", compacted]) == 0
    assert (index_io.load_index(compacted).fingerprint()
            == index_io.read_manifest(head)["fingerprint"]
            == ref_io.load_index(compacted).fingerprint())
    assert cli([
        "append", "--parent", str(tmp_path / "nope"), "--out",
        str(tmp_path / "x"), "--n-docs", "10", "--n-terms", "300",
    ]) == 1


# --------------------------------------------------------------------------
# Control plane: the topology journal replayed
# --------------------------------------------------------------------------

PLANE_KW = dict(use_mesh=False, spec=BucketSpec(max_batch=4),
                engine_kwargs=dict(k=5, device="cpu"))


def test_plane_journal_replay_reconstructs_cuts_and_ledger(base_index, tmp_path):
    """A second plane opened on the same artifact with replay=True resumes
    at the journaled layout and ledger and serves bitwise-identically."""
    path = str(tmp_path / "art")
    index_io.save_index(base_index, path)
    kw = dict(n_shards=3, **PLANE_KW)
    plane = ControlPlane.from_artifact(path, **kw)
    assert plane.journal is not None and not plane.journal.exists
    plane.start_reshard(np.asarray([0, 1, 4, 6]))
    while plane.reshard_task is not None:
        plane.drain_once()
    plane.mark_down(1)
    plane.mark_up(1)
    plane.mark_down(2)
    assert len(plane.journal.records()) == 4

    plane2 = ControlPlane.from_artifact(path, replay=True, **kw)
    np.testing.assert_array_equal(plane2.cuts, plane.cuts)
    np.testing.assert_array_equal(plane2.health._up, plane.health._up)
    assert plane2.reshards_completed == 1
    assert len(plane.journal.records()) == 4  # replay journals nothing

    log = make_query_log(make_corpus(n_docs=200, n_terms=700, n_topics=4, seed=2),
                         n_queries=6, seed=3)
    for i in range(log.n_queries):
        a = plane.bengine.run_batch([plane.engine.plan(log.terms[i])])[0]
        b = plane2.bengine.run_batch([plane2.engine.plan(log.terms[i])])[0]
        assert a.doc_ids.tolist() == b.doc_ids.tolist()
        assert a.scores.tolist() == b.scores.tolist()
        assert a.shard_exit_reasons == b.shard_exit_reasons
    # Dying mid-reshard: an uncommitted cutover leaves no record.
    plane.mark_up(2)
    plane.start_reshard(np.asarray([0, 2, 4, 6]))
    plane3 = ControlPlane.from_artifact(path, replay=True, **kw)
    np.testing.assert_array_equal(plane3.cuts, [0, 1, 4, 6])
    assert plane3.health.all_up


def test_replay_skips_health_records_from_before_last_reshard(base_index, tmp_path):
    path = str(tmp_path / "art")
    index_io.save_index(base_index, path)
    plane = ControlPlane.from_artifact(path, n_shards=4, **PLANE_KW)
    plane.mark_down(3)  # only valid under the 4-shard layout
    plane.mark_up(3)
    plane.start_reshard(np.asarray([0, 1, base_index.n_ranges]))  # 4 -> 2
    while plane.reshard_task is not None:
        plane.drain_once()
    plane.mark_down(1)
    plane2 = ControlPlane.from_artifact(path, n_shards=2, replay=True, **PLANE_KW)
    np.testing.assert_array_equal(plane2.cuts, [0, 1, base_index.n_ranges])
    assert plane2.reshards_completed == 1
    assert plane2.health.shard_down_mask().tolist() == [False, True]


def test_plane_refuses_foreign_journal(base_corpus, base_index, tmp_path):
    import shutil

    path = str(tmp_path / "art")
    index_io.save_index(base_index, path)
    plane = ControlPlane.from_artifact(path, n_shards=2, **PLANE_KW)
    plane.mark_down(0)
    other = build_index(base_corpus, n_ranges=4, strategy="clustered", seed=9)
    opath = str(tmp_path / "other")
    index_io.save_index(other, opath)
    shutil.copy(os.path.join(path, JOURNAL_NAME), os.path.join(opath, JOURNAL_NAME))
    with pytest.raises(index_io.ArtifactError, match="foreign"):
        ControlPlane.from_artifact(opath, n_shards=2, replay=True, **PLANE_KW)
    with pytest.raises(RuntimeError, match="no topology journal"):
        ControlPlane.from_artifact(opath, n_shards=2, journal=False,
                                   **PLANE_KW).replay_journal()


def test_plane_from_chain_head_with_journal(base_index, deltas, tmp_path):
    base, head = str(tmp_path / "base"), str(tmp_path / "head")
    index_io.save_index(base_index, base)
    ext = index_io.append_index(base, deltas[0], head, n_ranges=2, seed=5)
    plane = ControlPlane.from_artifact(head, n_shards=3, **PLANE_KW)
    assert plane.engine.index.fingerprint() == ext.fingerprint()
    plane.mark_down(2)
    assert plane.journal.records()[0]["fingerprint"] == ext.fingerprint()
    plane2 = ControlPlane.from_artifact(head, n_shards=3, replay=True, **PLANE_KW)
    assert plane2.health.shard_down_mask().tolist() == [False, False, True]


def _served_rows(served):
    return [[s.result.doc_ids.tolist(), s.result.scores.tolist(),
             list(s.result.shard_exit_reasons), int(s.result.fidelity_bound),
             bool(s.result.exact)] for s in sorted(served, key=lambda s: s.rid)]


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_journal_replays_across_packages(base_index, tmp_path, writer):
    """A journal written by either package's plane (a reshard, a health
    transition, same JSON and fingerprint stamp) replays in the other's:
    cuts, ledger and degraded answers equal."""
    path = str(tmp_path / "art")
    index_io.save_index(base_index, path)
    ref_kw = dict(n_shards=3, use_mesh=False, engine_kwargs=dict(k=5))
    port_kw = dict(n_shards=3, **PLANE_KW)
    make_writer, make_reader = (
        (lambda **kw: RefPlane.from_artifact(path, **ref_kw, **kw),
         lambda **kw: ControlPlane.from_artifact(path, **port_kw, **kw))
        if writer == "reference" else
        (lambda **kw: ControlPlane.from_artifact(path, **port_kw, **kw),
         lambda **kw: RefPlane.from_artifact(path, **ref_kw, **kw)))
    w = make_writer()
    w.start_reshard(np.asarray([0, 2, 5, 6]))
    while w.reshard_task is not None:
        w.drain_once()
    w.mark_down(1)
    records = w.journal.records()
    assert [r["kind"] for r in records] == ["reshard", "health"]
    assert {r["fingerprint"] for r in records} == {base_index.fingerprint()}
    r = make_reader(replay=True)
    assert r.cuts.tolist() == [0, 2, 5, 6] == w.cuts.tolist()
    assert r.health._up.tolist() == w.health._up.tolist()
    assert r.reshards_completed == 1
    log = make_query_log(make_corpus(n_docs=200, n_terms=700, n_topics=4, seed=2),
                         n_queries=6, seed=3)
    queries = [log.terms[i] for i in range(log.n_queries)]
    assert _served_rows(r.replay(queries, batch_size=4)) == _served_rows(
        w.replay(queries, batch_size=4))


_JOURNAL_SUBPROC = r"""
import json, sys
import numpy as np
from repro_torch import index_io
from repro_torch.control import ControlPlane
from repro_torch.core.clustered_index import build_index
from repro_torch.data.synth import make_corpus, make_query_log
from repro_torch.serving import BucketSpec

path, phase = sys.argv[1], sys.argv[2]
corpus = make_corpus(n_docs=900, n_terms=700, n_topics=4, mean_doc_len=50, seed=7)
log = make_query_log(corpus, n_queries=8, seed=8)
queries = [log.terms[i] for i in range(log.n_queries)]
kw = dict(n_shards=4, use_mesh=False, spec=BucketSpec(max_batch=4),
          engine_kwargs=dict(k=5, device="cpu"))

def rows(served):
    return [[s.result.doc_ids.tolist(), s.result.scores.tolist(),
             list(s.result.shard_exit_reasons), s.result.fidelity_bound,
             bool(s.result.exact)] for s in sorted(served, key=lambda s: s.rid)]

if phase == "write":
    index_io.save_index(build_index(corpus, n_ranges=8, strategy="clustered"), path)
    plane = ControlPlane.from_artifact(path, **kw)
    plane.start_reshard(np.asarray([0, 1, 3, 6, 8]))
    while plane.reshard_task is not None:
        plane.submit(queries[0]); plane.drain_once()
    plane.mark_down(3)
    with open(path + ".expect.json", "w") as f:
        json.dump({"cuts": plane.cuts.tolist(), "up": plane.health._up.tolist(),
                   "rows": rows(plane.replay(queries, batch_size=4))}, f)
    print("WRITE_OK", len(plane.journal.records()))
else:
    with open(path + ".expect.json") as f:
        expect = json.load(f)
    plane = ControlPlane.from_artifact(path, replay=True, **kw)
    assert plane.cuts.tolist() == expect["cuts"], plane.cuts
    assert plane.health._up.tolist() == expect["up"]
    assert rows(plane.replay(queries, batch_size=4)) == expect["rows"]
    print("REPLAY_OK", len(queries))
assert not [m for m in sys.modules if m.split(".")[0] in ("jax", "repro")]
"""


def test_journal_replay_across_process_boundary_subprocess(tmp_path):
    """A broker process exits after a journaled reshard and outage; a NEW
    process replays the journal and serves the degraded layout
    bitwise-identically (one device, no JAX in either process)."""
    path = str(tmp_path / "art")
    env = dict(os.environ, PYTHONPATH=os.path.join(_REPO_ROOT, "src"))
    for phase, marker in (("write", "WRITE_OK 2"), ("replay", "REPLAY_OK 8")):
        out = subprocess.run(
            [sys.executable, "-c", _JOURNAL_SUBPROC, path, phase],
            capture_output=True, text=True, env=env, cwd=_REPO_ROOT, timeout=600,
        )
        assert marker in out.stdout, out.stdout + out.stderr
