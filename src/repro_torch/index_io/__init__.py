"""Index lifecycle subsystem (DESIGN.md §8).

Three pillars:

  * **artifact** — a versioned on-disk representation of ``ClusteredIndex``
    and per-shard ``IndexShard`` sets: a JSON manifest (format version,
    build params, quantizer state, fingerprint) plus one ``.npy`` per array
    with optional memory-mapped loading. ``save_index``/``load_index`` and
    ``save_shards``/``load_shards`` round-trip bitwise — the loaded artifact
    produces `device_traverse` results identical to the in-memory build.
  * **corpus_io** — a ``Corpus`` reader registry: TSV/JSONL collection
    readers that run anywhere, and CIFF / ``ir_datasets`` readers gated
    behind the optional ``repro[corpus]`` extra with a clean error when the
    dependency is absent.
  * **native int8 impact storage** — artifacts persist impacts as biased
    int8 codes (``impact - IMPACT_BIAS``) and engines built from them keep
    postings impacts int8 in HBM, widening only inside the scorer gather
    (``kernels/range_scorer/ref.py``).

Incremental artifacts (DESIGN.md §10): ``save_delta``/``load_chain`` store
corpus appends as delta segments chained by ``parent_fingerprint``;
``append_index`` is the one-call append-and-publish, ``compact`` squashes a
chain into a fresh base bitwise-equal to a from-scratch build.

Bit-packed docids (DESIGN.md §12): format v2 artifacts can persist the
docid stream as per-block fixed-width packed deltas (``docs_format=
"packed"``); ``repack`` migrates existing artifacts in place-for-place
with an identical fingerprint.

CLI: ``python -m repro_torch.index_io
{build,append,compact,repack,log,inspect,validate}``.
"""

from repro_torch.index_io.artifact import (  # noqa: F401
    FORMAT_VERSION,
    SUPPORTED_FORMAT_VERSIONS,
    ArtifactError,
    CorruptArtifactError,
    VersionMismatchError,
    append_index,
    clean_stale_staging,
    compact,
    iter_chain,
    load_chain,
    load_index,
    load_shards,
    read_manifest,
    repack,
    save_delta,
    save_index,
    save_shards,
    validate_artifact,
)
from repro_torch.index_io.corpus_io import (  # noqa: F401
    MissingDependencyError,
    available_readers,
    get_reader,
    read_corpus,
    register_reader,
)

__all__ = [
    "FORMAT_VERSION",
    "SUPPORTED_FORMAT_VERSIONS",
    "ArtifactError",
    "CorruptArtifactError",
    "MissingDependencyError",
    "VersionMismatchError",
    "append_index",
    "available_readers",
    "clean_stale_staging",
    "compact",
    "get_reader",
    "iter_chain",
    "load_chain",
    "load_index",
    "load_shards",
    "read_corpus",
    "read_manifest",
    "register_reader",
    "repack",
    "save_delta",
    "save_index",
    "save_shards",
    "validate_artifact",
]
