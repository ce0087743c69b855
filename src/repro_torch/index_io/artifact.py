"""Versioned on-disk artifacts for built indexes (DESIGN.md §8, §10).

Layout — one directory per artifact:

    <path>/
      manifest.json            format version, build params, quantizer
                               state, fingerprint, per-array metadata
      arrays/<name>.npy        ClusteredIndex arrays (kind "clustered_index")
      shard_00000/<name>.npy   per-shard arrays      (kind "index_shards")
      arrays/<name>.npy        IndexDelta arrays     (kind "index_delta")

A delta artifact (DESIGN.md §10) stores only the appended documents'
postings, impacts, and arrangement, plus a manifest whose
``parent_fingerprint`` chains it to its base: ``parent`` is a relative path
to the parent artifact (another delta, or the base ``clustered_index``).
``load_index`` on a chain head follows parents to the base and materializes
the extended index link by link (``core.clustered_index.apply_delta``);
``compact`` squashes a chain into a fresh base bitwise-equal to a
from-scratch build on the concatenated corpus at the base's frozen
collection statistics.

Every array is a plain ``.npy`` file so loading can be eager
(``np.load``) or memory-mapped (``mmap_mode="r"``) without any format
change. Impacts are persisted at the chosen ``impact_dtype``: ``"int32"``
verbatim, or ``"int8"`` as the biased code ``impact - IMPACT_BIAS`` (the
same convention the device upload path uses — ``core.range_daat
.pack_impacts``). Loading always widens impacts back to exact int32 on the
host, so ``ClusteredIndex.fingerprint()`` is stable across save/load at
either dtype and traversal over a loaded artifact is bitwise identical to
the in-memory build.

Writes are atomic at directory granularity: arrays and manifest land in a
``<path>.tmp`` staging directory that is renamed into place last, so a
crashed save never leaves a half-artifact where a loader finds it.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile
import time

import numpy as np

from repro_torch.core.bm25 import BM25Params, CollectionStats
from repro_torch.core.clustered_index import (
    ClusteredIndex,
    IndexDelta,
    IndexShard,
    PackedPostings,
    apply_delta,
    plan_delta,
    unpack_docs,
)
from repro_torch.core.quantize import Quantizer
from repro_torch.core.range_daat import IMPACT_BIAS, IMPACT_DTYPES, pack_impacts
from repro_torch.core.reorder import Arrangement

__all__ = [
    "FORMAT",
    "FORMAT_VERSION",
    "ArtifactError",
    "CorruptArtifactError",
    "VersionMismatchError",
    "append_index",
    "clean_stale_staging",
    "compact",
    "iter_chain",
    "load_chain",
    "load_index",
    "load_shards",
    "read_manifest",
    "repack",
    "save_delta",
    "save_index",
    "save_shards",
    "validate_artifact",
]

FORMAT = "repro-index-artifact"
# Version history:
#   1 — initial artifact layout (raw int32 docs.npy always present).
#   2 — optional bit-packed docid deltas (DESIGN.md §12): manifest key
#       "docs_format", "packed" artifacts replace docs.npy with the
#       PACKED_ARRAYS below. v1 artifacts remain readable; writes are v2.
FORMAT_VERSION = 2
SUPPORTED_FORMAT_VERSIONS = (1, 2)

# Readers retry once on a path that vanished mid-read: the overwrite publish
# (``_atomic_publish``) swaps via rename-aside + rename-in, so a healthy
# artifact can be absent for the microseconds between the two renames.
_ENOENT_RETRY_S = 0.05

# A delta chain longer than this is assumed to be a parent-pointer cycle or
# a pathological artifact; compact long before here.
MAX_CHAIN_LENGTH = 4096

# ClusteredIndex fields persisted as arrays (arrangement flattened in).
INDEX_ARRAYS = (
    "ptr", "docs", "impacts",
    "blk_start", "blk_len", "blk_maxdoc", "blk_maximp", "blk_term", "blk_range",
    "tr_ptr", "tr_range", "tr_blk_start", "tr_blk_end", "tr_bound",
    "term_bound", "bounds_dense",
    "doc_order", "range_ends",
)

# Arrays replacing "docs" under docs_format="packed" (DESIGN.md §12): the
# shared uint32 delta word stream plus its per-block directory.
PACKED_ARRAYS = ("pack_words", "pack_start", "pack_width", "pack_first")

SHARD_ARRAYS = (
    "docs", "impacts", "blk_start", "blk_len", "blk_maxdoc", "blk_maximp",
    "blk_map", "range_starts", "range_sizes", "bounds_dense",
)

SHARD_SCALARS = ("shard_id", "range_lo", "range_hi", "doc_base", "n_docs", "postings")

# IndexDelta fields persisted as arrays (kind "index_delta").
DELTA_ARRAYS = ("ptr", "docs", "impacts", "doc_order", "range_ends")


class ArtifactError(Exception):
    """Base error for index artifact I/O."""


class CorruptArtifactError(ArtifactError):
    """Manifest unreadable, arrays missing, or metadata contradicts data."""


class VersionMismatchError(ArtifactError):
    """Artifact was written by an incompatible format version."""


# --------------------------------------------------------------------------
# Low-level helpers
# --------------------------------------------------------------------------


def _retry_enoent(fn):
    """Run ``fn``; on FileNotFoundError retry once after a short sleep.

    The reader half of the ``_atomic_publish`` contract: an overwrite swap
    admits a briefly-absent path, so one vanished open on a healthy artifact
    is expected, and only a *second* miss means the artifact is really gone.

    Scope: this protects against the absent-path window only. A reader that
    straddles a publish of *different content* (manifest from the old tree,
    arrays from the new) still gets a typed ``CorruptArtifactError`` from
    the dtype/shape/fingerprint checks — a clean retryable error, not
    torn data; full snapshot isolation would need versioned directories.
    """
    try:
        return fn()
    except FileNotFoundError:
        time.sleep(_ENOENT_RETRY_S)
        return fn()


def _sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _write_array(root: str, rel: str, arr: np.ndarray) -> dict:
    path = os.path.join(root, rel)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    # analysis: allow[ARTIFACT] root is the caller's mkdtemp *.tmp-*
    # staging dir; write_artifact publishes it with one os.replace.
    np.save(path, np.ascontiguousarray(arr))
    return {
        "file": rel,
        "dtype": str(arr.dtype),
        "shape": list(arr.shape),
        "sha256": _sha256_file(path),
    }


def _read_array(root: str, meta: dict, name: str, mmap: bool) -> np.ndarray:
    path = os.path.join(root, meta["file"])
    try:
        arr = _retry_enoent(
            lambda: np.load(
                path, mmap_mode="r" if mmap else None, allow_pickle=False
            )
        )
    except FileNotFoundError:
        raise CorruptArtifactError(
            f"array {name!r}: missing file {meta['file']}"
        ) from None
    except (ValueError, OSError) as e:
        raise CorruptArtifactError(f"array {name!r}: unreadable ({e})") from e
    if str(arr.dtype) != meta["dtype"] or list(arr.shape) != list(meta["shape"]):
        raise CorruptArtifactError(
            f"array {name!r}: manifest says {meta['dtype']}{meta['shape']}, "
            f"file holds {arr.dtype}{list(arr.shape)}"
        )
    return arr


def _pack_disk_impacts(impacts: np.ndarray, impact_dtype: str, bits: int) -> np.ndarray:
    """Disk uses the same representation the device upload path does
    (``pack_impacts``); this wrapper only adds the bit-width eligibility
    check, so the two conventions cannot drift apart."""
    if impact_dtype == "int8" and bits > 8:
        raise ValueError(f"impact_dtype='int8' needs quantizer.bits <= 8, got {bits}")
    return pack_impacts(impacts, impact_dtype)


def _unpack_disk_impacts(arr: np.ndarray, manifest: dict) -> np.ndarray:
    if manifest["impact_dtype"] == "int8":
        bias = int(manifest.get("impact_bias", IMPACT_BIAS))
        return (np.asarray(arr, np.int64) + bias).astype(np.int32)
    return np.asarray(arr, np.int32)


def _staging_dir(path: str) -> str:
    """Unique per-save staging directory beside the target.

    Unique (not a fixed ``<path>.tmp``) so concurrent saves of the same
    artifact — e.g. two processes missing the same ``build_index_cached``
    key — cannot clobber each other's half-written staging area; whoever
    publishes last simply wins the final rename.
    """
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    return tempfile.mkdtemp(prefix=os.path.basename(path) + ".tmp-", dir=parent)


def clean_stale_staging(path: str, max_age_s: float = 3600.0) -> list[str]:
    """Remove crashed saves' leftover staging dirs for this artifact path.

    A save that died mid-write leaves a ``<name>.tmp-*`` sibling behind;
    loaders never look at it (they address ``path`` directly), so it is
    inert but wastes disk. Only directories older than ``max_age_s`` are
    swept, so a *live* concurrent save's staging area is never clobbered.
    Returns the names removed. The CLI append/compact paths call this
    before staging their own write.
    """
    parent = os.path.dirname(os.path.abspath(path))
    prefix = os.path.basename(path) + ".tmp-"
    removed: list[str] = []
    if not os.path.isdir(parent):
        return removed
    now = time.time()
    for entry in os.listdir(parent):
        if not entry.startswith(prefix):
            continue
        full = os.path.join(parent, entry)
        try:
            if os.path.isdir(full) and now - os.path.getmtime(full) >= max_age_s:
                shutil.rmtree(full, ignore_errors=True)
                removed.append(entry)
        except OSError:
            continue  # raced a concurrent publish; nothing to sweep
    return removed


def _atomic_publish(tmp: str, path: str, overwrite: bool) -> None:
    """Rename the staging dir into place without a half-deleted window.

    Overwrite swaps in two renames — live artifact aside to a private
    name, staging dir in, old tree dropped last — so a concurrent reader
    observes the complete old artifact, a briefly-absent path (a cache
    *miss*, which rebuilds), or the complete new artifact; never a
    partially deleted directory. A lost publish race leaves the winner's
    equivalent artifact in place.
    """
    old = None
    if os.path.exists(path):
        if not overwrite:
            shutil.rmtree(tmp)
            raise ArtifactError(f"artifact already exists: {path} (overwrite=False)")
        old = tmp + ".old"  # unique: tmp is mkdtemp-fresh
        try:
            os.replace(path, old)
        except FileNotFoundError:
            old = None  # a concurrent publisher already swapped it away
    try:
        os.replace(tmp, path)
    except OSError:
        # Lost a publish race; the winner's artifact is equivalent.
        shutil.rmtree(tmp, ignore_errors=True)
        if not os.path.isdir(path):
            raise
    if old is not None:
        shutil.rmtree(old, ignore_errors=True)


def _write_manifest(root: str, manifest: dict) -> None:
    # analysis: allow[ARTIFACT] root is the staged dir, see _write_array
    with open(os.path.join(root, "manifest.json"), "w", encoding="utf-8") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)


def read_manifest(path: str) -> dict:
    """Load and version-check an artifact manifest.

    Raises ``CorruptArtifactError`` for missing/unreadable/foreign JSON and
    ``VersionMismatchError`` when the format version is not ours. Retries
    once when the path is briefly absent under a concurrent overwrite
    publish (see ``_atomic_publish``).
    """
    mpath = os.path.join(path, "manifest.json")

    def _read():
        with open(mpath, encoding="utf-8") as f:
            return json.load(f)

    try:
        manifest = _retry_enoent(_read)
    except FileNotFoundError:
        raise CorruptArtifactError(f"no manifest.json under {path}") from None
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        raise CorruptArtifactError(f"manifest.json unparseable: {e}") from e
    if not isinstance(manifest, dict) or manifest.get("format") != FORMAT:
        raise CorruptArtifactError(
            f"{mpath} is not a {FORMAT} manifest "
            f"(format={manifest.get('format') if isinstance(manifest, dict) else None!r})"
        )
    version = manifest.get("format_version")
    if version not in SUPPORTED_FORMAT_VERSIONS:
        raise VersionMismatchError(
            f"artifact format_version={version!r}, this reader supports "
            f"{SUPPORTED_FORMAT_VERSIONS} — rebuild the artifact or upgrade "
            f"the reader"
        )
    return manifest


# --------------------------------------------------------------------------
# ClusteredIndex save / load
# --------------------------------------------------------------------------


def _index_array(index: ClusteredIndex, name: str) -> np.ndarray:
    if name == "doc_order":
        return index.arrangement.doc_order
    if name == "range_ends":
        return index.arrangement.range_ends
    return getattr(index, name)


def save_index(
    index: ClusteredIndex,
    path: str,
    impact_dtype: str = "int32",
    build_params: dict | None = None,
    overwrite: bool = False,
    docs_format: str = "int32",
) -> str:
    """Persist a built index as a versioned artifact directory.

    ``impact_dtype="int8"`` stores postings impacts as biased int8 codes
    (4x smaller than int32); every other array keeps its native dtype.
    ``docs_format="packed"`` replaces ``docs.npy`` with the bit-packed
    delta stream + per-block directory (DESIGN.md §12); ``load_index``
    reconstructs the exact docid array, so the fingerprint — and therefore
    chain/shard compatibility — is unchanged. Returns ``path``.
    """
    tmp = _staging_dir(path)
    try:
        return _save_index_into(
            tmp, index, path, impact_dtype, build_params, overwrite, docs_format
        )
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)  # no orphaned staging dirs
        raise


def _save_index_into(
    tmp: str,
    index: ClusteredIndex,
    path: str,
    impact_dtype: str,
    build_params: dict | None,
    overwrite: bool,
    docs_format: str = "int32",
) -> str:
    if docs_format not in ("int32", "packed"):
        raise ValueError(f"docs_format {docs_format!r} not in ('int32', 'packed')")
    arrays = {}
    for name in INDEX_ARRAYS:
        if name == "docs" and docs_format == "packed":
            continue
        arr = _index_array(index, name)
        if name == "impacts":
            arr = _pack_disk_impacts(arr, impact_dtype, index.quantizer.bits)
        arrays[name] = _write_array(tmp, os.path.join("arrays", f"{name}.npy"), arr)
    if docs_format == "packed":
        packed = index.packed_postings()
        packed_arrs = {
            "pack_words": np.asarray(packed.words, np.uint32),
            "pack_start": np.asarray(packed.blk_word_start, np.int64),
            "pack_width": np.asarray(packed.blk_width, np.int32),
            "pack_first": np.asarray(packed.blk_first, np.int32),
        }
        for name, arr in packed_arrs.items():
            arrays[name] = _write_array(
                tmp, os.path.join("arrays", f"{name}.npy"), arr
            )
    collection = None
    if index.stats is not None:
        # Frozen collection statistics (DESIGN.md §10): df as an array (it
        # is NOT derivable from ptr once the index has been extended),
        # scalars + BM25 params in the manifest, so a reloaded artifact can
        # plan further deltas.
        arrays["stats_df"] = _write_array(
            tmp,
            os.path.join("arrays", "stats_df.npy"),
            np.asarray(index.stats.df, np.int64),
        )
        collection = {
            "n_docs": int(index.stats.n_docs),
            "avg_doc_len": float(index.stats.avg_doc_len),
            "bm25": {"k1": float(index.bm25.k1), "b": float(index.bm25.b)},
        }

    manifest = {
        "format": FORMAT,
        "format_version": FORMAT_VERSION,
        "kind": "clustered_index",
        "n_docs": int(index.n_docs),
        "n_terms": int(index.n_terms),
        "nnz": int(index.nnz),
        "impact_dtype": impact_dtype,
        "docs_format": docs_format,
        "quantizer": {
            "bits": int(index.quantizer.bits),
            "scale": float(index.quantizer.scale),
        },
        "arrangement": {
            "strategy": index.arrangement.strategy,
            "n_ranges": int(index.n_ranges),
        },
        "build_params": build_params or {},
        "fingerprint": index.fingerprint(),
        "arrays": arrays,
    }
    if collection is not None:
        manifest["collection"] = collection
    if impact_dtype == "int8":
        manifest["impact_bias"] = IMPACT_BIAS
    _write_manifest(tmp, manifest)
    _atomic_publish(tmp, path, overwrite)
    return path


def load_index(path: str, mmap: bool = False) -> ClusteredIndex:
    """Load a ``clustered_index`` artifact (or a delta-chain head) back
    into host memory.

    ``mmap=True`` memory-maps every array read-only instead of copying it —
    int8-stored impacts are the one exception, since they are widened back
    to exact int32 for the host structure (the device upload re-narrows via
    ``Engine(impact_dtype="int8")``). Pointing at an ``index_delta``
    artifact follows its parent chain and materializes the extended index
    (DESIGN.md §10).
    """
    manifest = read_manifest(path)
    if manifest.get("kind") == "index_delta":
        return load_chain(path, mmap=mmap)
    if manifest.get("kind") != "clustered_index":
        raise CorruptArtifactError(
            f"expected kind 'clustered_index', got {manifest.get('kind')!r}"
        )
    docs_format = manifest.get("docs_format", "int32")  # v1: always raw
    metas = manifest.get("arrays", {})
    if docs_format == "packed":
        expected = [n for n in INDEX_ARRAYS if n != "docs"] + list(PACKED_ARRAYS)
    else:
        expected = list(INDEX_ARRAYS)
    missing = [n for n in expected if n not in metas]
    if missing:
        raise CorruptArtifactError(f"manifest lacks arrays: {missing}")
    a = {n: _read_array(path, metas[n], n, mmap) for n in expected}
    a["impacts"] = _unpack_disk_impacts(a["impacts"], manifest)
    if docs_format == "packed":
        # Reconstruct the exact int32 docid array from the packed stream;
        # the fingerprint check below certifies the decode bitwise.
        packed = PackedPostings(
            words=np.asarray(a.pop("pack_words"), np.uint32),
            blk_word_start=np.asarray(a.pop("pack_start"), np.int64),
            blk_width=np.asarray(a.pop("pack_width"), np.int32),
            blk_first=np.asarray(a.pop("pack_first"), np.int32),
            n_postings=int(a["impacts"].shape[0]),
        )
        a["docs"] = unpack_docs(packed, a["blk_start"], a["blk_len"])

    q = manifest["quantizer"]
    arrangement = Arrangement(
        doc_order=a["doc_order"],
        range_ends=a["range_ends"],
        strategy=manifest["arrangement"]["strategy"],
    )
    stats = None
    bm25 = BM25Params()
    collection = manifest.get("collection")
    if (collection is None) != ("stats_df" not in metas):
        # Both or neither: a half-present stats record is corruption, not a
        # pre-§10 artifact — failing here beats an unexplainable "cannot
        # extend" much later.
        raise CorruptArtifactError(
            "inconsistent frozen collection stats: manifest 'collection' "
            "and arrays entry 'stats_df' must both be present or both absent"
        )
    if collection is not None and "stats_df" in metas:
        stats = CollectionStats(
            n_docs=int(collection["n_docs"]),
            avg_doc_len=float(collection["avg_doc_len"]),
            df=np.asarray(
                _read_array(path, metas["stats_df"], "stats_df", mmap), np.int64
            ),
        )
        bm25 = BM25Params(
            k1=float(collection["bm25"]["k1"]), b=float(collection["bm25"]["b"])
        )
    index = ClusteredIndex(
        n_docs=int(manifest["n_docs"]),
        n_terms=int(manifest["n_terms"]),
        arrangement=arrangement,
        quantizer=Quantizer(bits=int(q["bits"]), scale=float(q["scale"])),
        stats=stats,
        bm25=bm25,
        **{n: a[n] for n in INDEX_ARRAYS if n not in ("doc_order", "range_ends")},
    )
    if index.fingerprint() != manifest["fingerprint"]:
        raise CorruptArtifactError(
            f"fingerprint mismatch: manifest {manifest['fingerprint']}, "
            f"loaded arrays {index.fingerprint()}"
        )
    return index


def repack(
    path: str,
    out: str,
    docs_format: str = "packed",
    impact_dtype: str | None = None,
    overwrite: bool = False,
) -> str:
    """Re-save an existing index artifact under another ``docs_format``.

    The migration path for pre-v2 (and raw-int32 v2) artifacts: load,
    re-encode the docid stream, save at the current format version. The
    index arrays are untouched bytes-for-bytes — a repacked artifact's
    arrays are identical to saving the source index packed from scratch,
    and its fingerprint matches the source. ``impact_dtype`` defaults to
    whatever the source artifact stored. Returns ``out``.
    """
    manifest = read_manifest(path)
    index = load_index(path)
    if impact_dtype is None:
        impact_dtype = manifest.get("impact_dtype", "int32")
    params = dict(manifest.get("build_params") or {})
    params["repacked_from"] = os.path.abspath(path)
    return save_index(
        index,
        out,
        impact_dtype=impact_dtype,
        build_params=params,
        overwrite=overwrite,
        docs_format=docs_format,
    )


# --------------------------------------------------------------------------
# Delta segments + manifest chain (DESIGN.md §10)
# --------------------------------------------------------------------------


def save_delta(
    delta: IndexDelta,
    path: str,
    parent_path: str,
    result_fingerprint: str,
    impact_dtype: str = "int32",
    overwrite: bool = False,
) -> str:
    """Persist an ``IndexDelta`` as a chain link under ``parent_path``.

    The delta directory stores only the appended documents' arrays (a few
    percent of a full re-save for a small append); the manifest records a
    *relative* ``parent`` path (the chain moves as a tree) plus
    ``parent_fingerprint`` — refused unless it matches the parent artifact,
    so a delta can never silently chain to the wrong base.
    ``result_fingerprint`` is the fingerprint of the materialized extended
    index (``apply_delta(parent, delta).fingerprint()``), which loaders
    verify after materialization.
    """
    parent = read_manifest(parent_path)
    if parent.get("kind") not in ("clustered_index", "index_delta"):
        raise ArtifactError(
            f"parent {parent_path} has kind {parent.get('kind')!r}; a delta "
            f"chains to a clustered_index base or another delta"
        )
    if parent.get("fingerprint") != delta.parent_fingerprint:
        raise ArtifactError(
            f"delta was planned against index {delta.parent_fingerprint}, "
            f"but parent artifact {parent_path} holds "
            f"{parent.get('fingerprint')} — refusing a mis-chained delta"
        )
    chain_length = int(parent.get("chain_length", 0)) + 1
    if chain_length > MAX_CHAIN_LENGTH:
        raise ArtifactError(
            f"chain would be {chain_length} links long (max "
            f"{MAX_CHAIN_LENGTH}); compact the chain first"
        )
    quantizer = parent.get("quantizer")
    if quantizer is None:
        raise CorruptArtifactError(
            f"parent {parent_path} records no quantizer state"
        )
    tmp = _staging_dir(path)
    try:
        return _save_delta_into(
            tmp, delta, path, parent_path, parent, chain_length,
            result_fingerprint, impact_dtype, overwrite,
        )
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)  # no orphaned staging dirs
        raise


def _save_delta_into(
    tmp: str,
    delta: IndexDelta,
    path: str,
    parent_path: str,
    parent: dict,
    chain_length: int,
    result_fingerprint: str,
    impact_dtype: str,
    overwrite: bool,
) -> str:
    arrays = {}
    for name in DELTA_ARRAYS:
        arr = getattr(delta, name)
        if name == "impacts":
            arr = _pack_disk_impacts(
                arr, impact_dtype, int(parent["quantizer"]["bits"])
            )
        arrays[name] = _write_array(tmp, os.path.join("arrays", f"{name}.npy"), arr)

    manifest = {
        "format": FORMAT,
        "format_version": FORMAT_VERSION,
        "kind": "index_delta",
        "parent": os.path.relpath(
            os.path.abspath(parent_path), start=os.path.abspath(path)
        ),
        "parent_fingerprint": delta.parent_fingerprint,
        "fingerprint": result_fingerprint,
        "chain_length": chain_length,
        "n_docs": int(delta.n_docs),
        "n_docs_total": int(
            parent.get("n_docs_total", parent.get("n_docs", 0))
        ) + int(delta.n_docs),
        "n_terms": int(delta.n_terms),
        "n_ranges": int(delta.n_ranges),
        "impact_dtype": impact_dtype,
        "quantizer": dict(parent["quantizer"]),
        "arrays": arrays,
    }
    if impact_dtype == "int8":
        manifest["impact_bias"] = IMPACT_BIAS
    _write_manifest(tmp, manifest)
    _atomic_publish(tmp, path, overwrite)
    return path


def _resolve_parent(path: str, manifest: dict) -> str:
    rel = manifest.get("parent")
    if not isinstance(rel, str) or not rel:
        raise CorruptArtifactError(f"{path}: delta manifest lacks a parent path")
    return os.path.normpath(os.path.join(path, rel))


def _load_delta_record(path: str, manifest: dict, mmap: bool) -> IndexDelta:
    metas = manifest.get("arrays", {})
    missing = [n for n in DELTA_ARRAYS if n not in metas]
    if missing:
        raise CorruptArtifactError(f"delta manifest lacks arrays: {missing}")
    a = {n: _read_array(path, metas[n], n, mmap) for n in DELTA_ARRAYS}
    a["impacts"] = _unpack_disk_impacts(a["impacts"], manifest)
    return IndexDelta(
        n_docs=int(manifest["n_docs"]),
        n_terms=int(manifest["n_terms"]),
        parent_fingerprint=manifest["parent_fingerprint"],
        ptr=np.asarray(a["ptr"], np.int64),
        docs=np.asarray(a["docs"], np.int32),
        impacts=a["impacts"],
        doc_order=np.asarray(a["doc_order"], np.int64),
        range_ends=np.asarray(a["range_ends"], np.int64),
    )


def iter_chain(path: str):
    """Yield ``(path, manifest)`` per chain link — head first, base last.

    The one chain walk (shared by :func:`load_chain` and the CLI ``log``):
    resolves relative ``parent`` pointers, guards against cycles and
    over-long chains, and guarantees the final yielded link is the
    ``clustered_index`` base — anything else raises
    ``CorruptArtifactError``. A bare base artifact yields just itself.
    """
    seen: set[str] = set()
    p, manifest = path, read_manifest(path)
    while manifest.get("kind") == "index_delta":
        key = os.path.abspath(p)
        if key in seen or len(seen) >= MAX_CHAIN_LENGTH:
            raise CorruptArtifactError(
                f"delta chain at {path} cycles or exceeds "
                f"{MAX_CHAIN_LENGTH} links"
            )
        seen.add(key)
        yield p, manifest
        p = _resolve_parent(p, manifest)
        manifest = read_manifest(p)
    if manifest.get("kind") != "clustered_index":
        raise CorruptArtifactError(
            f"chain base {p} has kind {manifest.get('kind')!r}, expected "
            f"'clustered_index'"
        )
    yield p, manifest


def load_chain(path: str, mmap: bool = False) -> ClusteredIndex:
    """Materialize a delta-chain head into one extended ``ClusteredIndex``.

    Walks ``parent`` pointers to the ``clustered_index`` base, then applies
    each delta oldest-first. Every link is verified twice: ``apply_delta``
    refuses a delta whose ``parent_fingerprint`` does not match what the
    chain materialized so far, and the materialized fingerprint must equal
    each link's manifest ``fingerprint``. Cycles and over-long chains raise
    ``CorruptArtifactError``.
    """
    links = list(iter_chain(path))
    index = load_index(links[-1][0], mmap=mmap)
    for dp, dm in reversed(links[:-1]):
        delta = _load_delta_record(dp, dm, mmap)
        try:
            index = apply_delta(index, delta)
        except ValueError as e:
            raise CorruptArtifactError(f"{dp}: {e}") from e
        if index.fingerprint() != dm.get("fingerprint"):
            raise CorruptArtifactError(
                f"{dp}: materialized fingerprint {index.fingerprint()} != "
                f"manifest {dm.get('fingerprint')}"
            )
    return index


def compact(
    path: str,
    out: str,
    impact_dtype: str | None = None,
    overwrite: bool = False,
) -> str:
    """Squash a delta chain into a fresh base artifact.

    The compacted base is bitwise-equal to a from-scratch
    ``clustered_index`` build on the concatenated corpus (at the chain's
    shared arrangement, quantizer, and frozen collection statistics) — the
    §10 tier-1 invariant, pinned by tests. ``impact_dtype`` defaults to the
    chain head's storage dtype. Compacting an un-chained base is a plain
    re-save (useful to shed a long-gone chain's journal).
    """
    manifest = read_manifest(path)
    if impact_dtype is None:
        impact_dtype = manifest.get("impact_dtype", "int32")
    index = load_index(path, mmap=True)
    return save_index(
        index,
        out,
        impact_dtype=impact_dtype,
        build_params={
            "compacted_from": os.path.abspath(path),
            "chain_length": int(manifest.get("chain_length", 0)),
        },
        overwrite=overwrite,
    )


def append_index(
    parent_path: str,
    corpus_delta,
    path: str,
    impact_dtype: str | None = None,
    overwrite: bool = False,
    n_ranges: int = 1,
    strategy: str = "clustered",
    seed: int = 0,
) -> ClusteredIndex:
    """Extend a saved artifact (or chain head) with a delta corpus.

    Loads/materializes the parent, plans + applies the delta, publishes a
    new chain link at ``path``, and returns the extended in-memory index
    (ready to serve — no reload needed). ``impact_dtype`` defaults to the
    parent's storage dtype. Stale staging leftovers for ``path`` from a
    crashed earlier append are swept first.
    """
    parent_manifest = read_manifest(parent_path)
    if impact_dtype is None:
        impact_dtype = parent_manifest.get("impact_dtype", "int32")
    index = load_index(parent_path)
    delta = plan_delta(
        index, corpus_delta, n_ranges=n_ranges, strategy=strategy, seed=seed
    )
    extended = apply_delta(index, delta)
    clean_stale_staging(path)
    save_delta(
        delta,
        path,
        parent_path,
        result_fingerprint=extended.fingerprint(),
        impact_dtype=impact_dtype,
        overwrite=overwrite,
    )
    return extended


# --------------------------------------------------------------------------
# IndexShard save / load
# --------------------------------------------------------------------------


def save_shards(
    shards: list[IndexShard],
    path: str,
    impact_dtype: str = "int32",
    quantizer: Quantizer | None = None,
    source_fingerprint: str | None = None,
    overwrite: bool = False,
) -> str:
    """Persist a shard set (``shard_device_index`` output) as one artifact.

    One subdirectory per shard; scalar shard metadata lives in the
    manifest. ``quantizer`` (the *global* scale shared by all shards) is
    **required** for int8 storage — the bit width decides whether biased
    int8 codes can represent every impact, and guessing would let >8-bit
    impacts wrap silently. ``source_fingerprint`` records the fingerprint
    of the index the shards were carved from, so loaders
    (``ShardedEngine.from_artifact``) can refuse a stale shard set.
    """
    if not shards:
        raise ValueError("cannot save an empty shard list")
    if impact_dtype == "int8" and quantizer is None:
        raise ValueError(
            "impact_dtype='int8' requires quantizer= (its bit width decides "
            "whether impacts fit a biased int8 code)"
        )
    bits = quantizer.bits if quantizer is not None else 32
    tmp = _staging_dir(path)
    try:
        return _save_shards_into(
            tmp, shards, path, impact_dtype, bits, quantizer,
            source_fingerprint, overwrite,
        )
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)  # no orphaned staging dirs
        raise


def _save_shards_into(
    tmp: str,
    shards: list[IndexShard],
    path: str,
    impact_dtype: str,
    bits: int,
    quantizer: Quantizer | None,
    source_fingerprint: str | None,
    overwrite: bool,
) -> str:
    shard_rows = []
    for shard in shards:
        sdir = f"shard_{shard.shard_id:05d}"
        arrays = {}
        for name in SHARD_ARRAYS:
            arr = getattr(shard, name)
            if name == "impacts":
                arr = _pack_disk_impacts(arr, impact_dtype, bits)
            arrays[name] = _write_array(tmp, os.path.join(sdir, f"{name}.npy"), arr)
        row = {s: int(getattr(shard, s)) for s in SHARD_SCALARS}
        row["arrays"] = arrays
        shard_rows.append(row)

    manifest = {
        "format": FORMAT,
        "format_version": FORMAT_VERSION,
        "kind": "index_shards",
        "n_shards": len(shards),
        "impact_dtype": impact_dtype,
        "shards": shard_rows,
    }
    # Contiguous layouts additionally record their range cuts, so reshard
    # tooling (the control plane, DESIGN.md §9) can read the layout without
    # loading any array. Non-contiguous shard sets (not produced by
    # shard_device_index) simply omit the key.
    lows = sorted((s.range_lo, s.range_hi) for s in shards)
    if lows[0][0] == 0 and all(
        a[1] == b[0] for a, b in zip(lows, lows[1:])
    ):
        manifest["range_cuts"] = [lo for lo, _ in lows] + [lows[-1][1]]
    if impact_dtype == "int8":
        manifest["impact_bias"] = IMPACT_BIAS
    if quantizer is not None:
        manifest["quantizer"] = {
            "bits": int(quantizer.bits),
            "scale": float(quantizer.scale),
        }
    if source_fingerprint is not None:
        manifest["source_fingerprint"] = source_fingerprint
    _write_manifest(tmp, manifest)
    _atomic_publish(tmp, path, overwrite)
    return path


def load_shards(path: str, mmap: bool = False) -> list[IndexShard]:
    """Load an ``index_shards`` artifact back into ``IndexShard`` objects."""
    manifest = read_manifest(path)
    if manifest.get("kind") != "index_shards":
        raise CorruptArtifactError(
            f"expected kind 'index_shards', got {manifest.get('kind')!r}"
        )
    rows = manifest.get("shards", [])
    if len(rows) != manifest.get("n_shards"):
        raise CorruptArtifactError(
            f"manifest n_shards={manifest.get('n_shards')} but "
            f"{len(rows)} shard entries"
        )
    shards = []
    for row in rows:
        metas = row["arrays"]
        missing = [n for n in SHARD_ARRAYS if n not in metas]
        if missing:
            raise CorruptArtifactError(
                f"shard {row.get('shard_id')}: manifest lacks arrays {missing}"
            )
        a = {
            n: _read_array(path, metas[n], f"shard/{n}", mmap)
            for n in SHARD_ARRAYS
        }
        a["impacts"] = _unpack_disk_impacts(a["impacts"], manifest)
        shards.append(
            IndexShard(**{s: int(row[s]) for s in SHARD_SCALARS}, **a)
        )
    return shards


# --------------------------------------------------------------------------
# Validation
# --------------------------------------------------------------------------


def _iter_array_metas(manifest: dict):
    if manifest["kind"] in ("clustered_index", "index_delta"):
        yield from manifest.get("arrays", {}).items()
    else:
        for row in manifest.get("shards", []):
            for name, meta in row.get("arrays", {}).items():
                yield f"shard_{row.get('shard_id')}/{name}", meta


def validate_artifact(path: str) -> list[str]:
    """Deep-check an artifact; returns a list of problems (empty = valid).

    Verifies the manifest parses at our format version, every array file
    exists with the advertised dtype/shape and sha256, and — for index
    artifacts — that the arrays rebuild to the manifest's fingerprint
    (``load_index`` enforces that too; here it lands in the report instead
    of raising).
    """
    problems: list[str] = []
    try:
        manifest = read_manifest(path)
    except ArtifactError as e:
        return [str(e)]

    for name, meta in _iter_array_metas(manifest):
        fpath = os.path.join(path, meta["file"])
        try:
            digest = _retry_enoent(lambda: _sha256_file(fpath))
        except FileNotFoundError:
            problems.append(f"{name}: missing file {meta['file']}")
            continue
        if digest != meta["sha256"]:
            problems.append(
                f"{name}: sha256 mismatch (manifest {meta['sha256'][:12]}…, "
                f"file {digest[:12]}…)"
            )
        try:
            _read_array(path, meta, name, mmap=True)
        except CorruptArtifactError as e:
            problems.append(str(e))

    if not problems and manifest["kind"] == "clustered_index":
        try:
            load_index(path, mmap=True)
        except ArtifactError as e:
            problems.append(str(e))
    if not problems and manifest["kind"] == "index_delta":
        # A delta is only as valid as its chain: materialize it, which
        # checks every parent link's fingerprint on the way.
        try:
            load_chain(path, mmap=True)
        except ArtifactError as e:
            problems.append(str(e))
    return problems
