"""Index lifecycle CLI (DESIGN.md §8, §10).

    python -m repro_torch.index_io build    --out DIR [--reader synth|tsv|jsonl|ciff|ir_datasets]
                                            [--source PATH_OR_ID] [--impact-dtype int8|int32]
                                            [--docs-format int32|packed]
                                            [--shards N] [index-build options]
    python -m repro_torch.index_io append   --parent DIR --out DIR [--reader ...]
                                            [--source ...] [--n-ranges N] [--strategy S]
    python -m repro_torch.index_io compact  DIR --out DIR [--impact-dtype int8|int32]
    python -m repro_torch.index_io repack   DIR --out DIR [--docs-format int32|packed]
                                            [--impact-dtype int8|int32]
    python -m repro_torch.index_io log      DIR
    python -m repro_torch.index_io inspect  DIR [--json]
    python -m repro_torch.index_io validate DIR

``build`` ingests a corpus through the reader registry, builds the
cluster-skipping index, and saves a versioned artifact (optionally plus a
range-sharded artifact). ``append`` ingests a *delta* corpus and publishes
it as a chain link under an existing artifact (or chain head); ``compact``
squashes a chain into a fresh base; ``repack`` migrates an artifact to a
different docid encoding (DESIGN.md §12 bit-packed deltas) with an
identical fingerprint; ``log`` prints the chain links and any
topology-journal records at the head. ``inspect`` prints the manifest,
per-array table, and space report without loading postings eagerly.
``validate`` deep-checks checksums, dtypes/shapes, and the index
fingerprint (for a delta: the whole chain).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from repro_torch.index_io import artifact, corpus_io


def _build(args: argparse.Namespace) -> int:
    from repro_torch.core.clustered_index import build_index, shard_device_index

    if args.impact_dtype == "int8" and args.bits > 8:
        raise ValueError(
            f"--impact-dtype int8 needs --bits <= 8 (got {args.bits}); "
            f"use --impact-dtype int32 for wider quantization"
        )

    reader_kw = {}
    if args.reader == "synth":
        reader_kw = dict(
            n_docs=args.n_docs, n_terms=args.n_terms, n_topics=args.n_topics,
            mean_doc_len=args.mean_doc_len, seed=args.seed,
        )
    elif args.max_docs is not None:
        reader_kw = dict(max_docs=args.max_docs)

    t0 = time.perf_counter()
    corpus = corpus_io.read_corpus(args.reader, args.source, **reader_kw)
    t1 = time.perf_counter()
    print(
        f"read [{args.reader}] {corpus.n_docs} docs, {corpus.n_terms} terms, "
        f"{corpus.nnz} doc-term pairs ({t1 - t0:.1f}s)"
    )

    index = build_index(
        corpus, n_ranges=args.n_ranges, strategy=args.strategy,
        bits=args.bits, seed=args.seed,
    )
    t2 = time.perf_counter()
    print(
        f"built index: {index.nnz} postings, {index.n_blocks} blocks, "
        f"{index.n_ranges} ranges ({t2 - t1:.1f}s)"
    )

    build_params = dict(
        reader=args.reader, source=args.source, n_ranges=args.n_ranges,
        strategy=args.strategy, bits=args.bits, seed=args.seed,
    )
    artifact.save_index(
        index, args.out, impact_dtype=args.impact_dtype,
        build_params=build_params, overwrite=args.overwrite,
        docs_format=args.docs_format,
    )
    print(
        f"saved {args.out} (impact_dtype={args.impact_dtype}, "
        f"docs_format={args.docs_format})"
    )

    if args.shards:
        shards = shard_device_index(index, args.shards)
        spath = args.out + f".shards{args.shards}"
        artifact.save_shards(
            shards, spath, impact_dtype=args.impact_dtype,
            quantizer=index.quantizer,
            source_fingerprint=index.fingerprint(),
            overwrite=args.overwrite,
        )
        print(f"saved {spath} ({args.shards} range shards)")
    return 0


def _append(args: argparse.Namespace) -> int:
    reader_kw = {}
    if args.reader == "synth":
        reader_kw = dict(
            n_docs=args.n_docs, n_terms=args.n_terms, n_topics=args.n_topics,
            mean_doc_len=args.mean_doc_len, seed=args.seed,
        )
    elif args.max_docs is not None:
        reader_kw = dict(max_docs=args.max_docs)

    t0 = time.perf_counter()
    delta_corpus = corpus_io.read_corpus(args.reader, args.source, **reader_kw)
    t1 = time.perf_counter()
    print(
        f"read [{args.reader}] delta: {delta_corpus.n_docs} docs, "
        f"{delta_corpus.nnz} doc-term pairs ({t1 - t0:.1f}s)"
    )
    extended = artifact.append_index(
        args.parent, delta_corpus, args.out,
        impact_dtype=args.impact_dtype, overwrite=args.overwrite,
        n_ranges=args.n_ranges, strategy=args.strategy, seed=args.seed,
    )
    t2 = time.perf_counter()
    head = artifact.read_manifest(args.out)
    print(
        f"appended -> {args.out}: chain length {head['chain_length']}, "
        f"{extended.n_docs} docs total, {extended.n_ranges} ranges, "
        f"fingerprint {extended.fingerprint()} ({t2 - t1:.1f}s)"
    )
    return 0


def _compact(args: argparse.Namespace) -> int:
    t0 = time.perf_counter()
    head = artifact.read_manifest(args.path)
    artifact.clean_stale_staging(args.out)
    artifact.compact(
        args.path, args.out,
        impact_dtype=args.impact_dtype, overwrite=args.overwrite,
    )
    t1 = time.perf_counter()
    print(
        f"compacted {args.path} (chain length "
        f"{head.get('chain_length', 0)}) -> {args.out} ({t1 - t0:.1f}s)"
    )
    return 0


def _repack(args: argparse.Namespace) -> int:
    t0 = time.perf_counter()
    src = artifact.read_manifest(args.path)
    artifact.repack(
        args.path, args.out,
        docs_format=args.docs_format, impact_dtype=args.impact_dtype,
        overwrite=args.overwrite,
    )
    t1 = time.perf_counter()
    head = artifact.read_manifest(args.out)
    print(
        f"repacked {args.path} "
        f"(docs_format={src.get('docs_format', 'int32')}) -> {args.out} "
        f"(docs_format={head['docs_format']}, "
        f"impact_dtype={head['impact_dtype']}), "
        f"fingerprint {head['fingerprint']} ({t1 - t0:.1f}s)"
    )
    return 0


def _log(args: argparse.Namespace) -> int:
    # Chain links, head first (iter_chain owns the walk + cycle guard).
    for path, manifest in artifact.iter_chain(args.path):
        if manifest["kind"] == "index_delta":
            print(
                f"{path}: delta +{manifest['n_docs']} docs "
                f"(total {manifest.get('n_docs_total', '?')}), "
                f"chain length {manifest.get('chain_length', '?')}, "
                f"fingerprint {manifest['fingerprint']} "
                f"<- parent {manifest['parent_fingerprint']}"
            )
        else:
            print(
                f"{path}: {manifest['kind']} base, "
                f"{manifest.get('n_docs', '?')} docs, "
                f"fingerprint {manifest.get('fingerprint', '?')}"
            )

    # Topology-journal records at the head (DESIGN.md §10).
    from repro_torch.control.journal import JOURNAL_NAME, TopologyJournal

    journal = TopologyJournal(os.path.join(args.path, JOURNAL_NAME))
    records = journal.records()
    if not records:
        print("journal: (no records)")
        return 0
    print(f"journal: {len(records)} record(s)")
    for rec in records:
        kind = rec.get("kind")
        if kind == "reshard":
            detail = f"cuts={rec.get('cuts')}"
        elif kind == "health":
            detail = (
                f"{rec.get('event')} shard={rec.get('shard')} "
                f"replica={rec.get('replica')}"
            )
        else:
            detail = json.dumps({k: v for k, v in rec.items() if k != "kind"})
        print(f"  [{rec.get('seq')}] {kind}: {detail}")
    return 0


def _inspect(args: argparse.Namespace) -> int:
    manifest = artifact.read_manifest(args.path)
    if args.json:
        json.dump(manifest, sys.stdout, indent=1, sort_keys=True)
        print()
        return 0

    kind = manifest["kind"]
    print(f"{args.path}: {kind} (format v{manifest['format_version']})")
    if kind == "clustered_index":
        q = manifest["quantizer"]
        print(
            f"  {manifest['n_docs']} docs, {manifest['n_terms']} terms, "
            f"{manifest['arrangement']['n_ranges']} ranges "
            f"({manifest['arrangement']['strategy']}), "
            f"{q['bits']}-bit impacts stored as {manifest['impact_dtype']}, "
            f"docids {manifest.get('docs_format', 'int32')}"
        )
        print(f"  fingerprint {manifest['fingerprint']}")
        rows = manifest["arrays"].items()
    elif kind == "index_delta":
        print(
            f"  +{manifest['n_docs']} docs (total {manifest['n_docs_total']}), "
            f"{manifest['n_ranges']} delta ranges, chain length "
            f"{manifest['chain_length']}, impacts stored as "
            f"{manifest['impact_dtype']}"
        )
        print(
            f"  fingerprint {manifest['fingerprint']} <- parent "
            f"{manifest['parent_fingerprint']} ({manifest['parent']})"
        )
        rows = manifest["arrays"].items()
    else:
        print(
            f"  {manifest['n_shards']} shards, impacts stored as "
            f"{manifest['impact_dtype']}"
        )
        rows = [
            (f"shard_{r['shard_id']}/{n}", m)
            for r in manifest["shards"]
            for n, m in r["arrays"].items()
        ]
    print(f"  {'array':<28}{'dtype':<8}{'shape':<18}bytes")
    total = 0
    for name, meta in rows:
        nbytes = os.path.getsize(os.path.join(args.path, meta["file"]))
        total += nbytes
        print(f"  {name:<28}{meta['dtype']:<8}{str(meta['shape']):<18}{nbytes}")
    print(f"  on-disk total: {total / 1e6:.2f} MB")

    if kind == "clustered_index":
        # Manifest metadata alone — no array is read, so inspect stays
        # cheap on collection-scale artifacts.
        from repro_torch.core.clustered_index import device_bytes_report

        docs_format = manifest.get("docs_format", "int32")
        arrays = manifest["arrays"]
        n_pack_words = (
            arrays["pack_words"]["shape"][0] if docs_format == "packed" else 0
        )
        dev = device_bytes_report(
            nnz=manifest.get("nnz", arrays["impacts"]["shape"][0]),
            n_blocks=arrays["blk_start"]["shape"][0],
            n_terms=manifest["n_terms"],
            n_ranges=manifest["arrangement"]["n_ranges"],
            impact_dtype=manifest["impact_dtype"],
            docs_format=docs_format,
            n_pack_words=n_pack_words,
        )
        print(
            f"  device (HBM) at {manifest['impact_dtype']}/{docs_format}: "
            f"postings={dev['postings']} B (docs={dev['docs']}, "
            f"impacts={dev['impacts']}), total={dev['total']} B"
        )
    return 0


def _validate(args: argparse.Namespace) -> int:
    problems = artifact.validate_artifact(args.path)
    if problems:
        print(f"INVALID: {args.path}")
        for p in problems:
            print(f"  - {p}")
        return 1
    print(f"OK: {args.path} validates (checksums, shapes, fingerprint)")
    return 0


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.index_io", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    sub = parser.add_subparsers(dest="cmd", required=True)

    b = sub.add_parser("build", help="ingest a corpus and save an index artifact")
    b.add_argument("--out", required=True, help="artifact directory to create")
    b.add_argument("--reader", default="synth",
                   help="corpus reader (see repro_torch.index_io.available_readers)")
    b.add_argument("--source", default="",
                   help="reader source: file path, or ir_datasets id")
    b.add_argument("--impact-dtype", default="int8", choices=("int8", "int32"))
    b.add_argument("--docs-format", default="int32", choices=("int32", "packed"),
                   help="docid storage: raw int32 or bit-packed block deltas")
    b.add_argument("--overwrite", action="store_true")
    b.add_argument("--shards", type=int, default=0,
                   help="also save a range-sharded artifact with N shards")
    b.add_argument("--n-ranges", type=int, default=32)
    b.add_argument("--strategy", default="clustered_bp")
    b.add_argument("--bits", type=int, default=8)
    b.add_argument("--seed", type=int, default=0)
    b.add_argument("--max-docs", type=int, default=None,
                   help="cap ingested documents (tsv/jsonl/ciff/ir_datasets)")
    b.add_argument("--n-docs", type=int, default=8000, help="synth reader only")
    b.add_argument("--n-terms", type=int, default=6000, help="synth reader only")
    b.add_argument("--n-topics", type=int, default=16, help="synth reader only")
    b.add_argument("--mean-doc-len", type=int, default=150, help="synth reader only")
    b.set_defaults(fn=_build)

    a = sub.add_parser(
        "append", help="ingest a delta corpus and publish a chain link"
    )
    a.add_argument("--parent", required=True,
                   help="existing index artifact or chain head to extend")
    a.add_argument("--out", required=True, help="delta directory to create")
    a.add_argument("--reader", default="synth")
    a.add_argument("--source", default="",
                   help="reader source: file path, or ir_datasets id")
    a.add_argument("--impact-dtype", default=None, choices=("int8", "int32"),
                   help="delta impact storage (default: parent's dtype)")
    a.add_argument("--overwrite", action="store_true")
    a.add_argument("--n-ranges", type=int, default=1,
                   help="ranges to carve the delta into (appended at the tail)")
    a.add_argument("--strategy", default="clustered",
                   help="delta arrangement strategy")
    a.add_argument("--seed", type=int, default=0)
    a.add_argument("--max-docs", type=int, default=None,
                   help="cap ingested documents (tsv/jsonl/ciff/ir_datasets)")
    a.add_argument("--n-docs", type=int, default=500, help="synth reader only")
    a.add_argument("--n-terms", type=int, default=6000, help="synth reader only")
    a.add_argument("--n-topics", type=int, default=16, help="synth reader only")
    a.add_argument("--mean-doc-len", type=int, default=150, help="synth reader only")
    a.set_defaults(fn=_append)

    c = sub.add_parser(
        "compact", help="squash a delta chain into a fresh base artifact"
    )
    c.add_argument("path", help="chain head (or base) to compact")
    c.add_argument("--out", required=True, help="compacted artifact directory")
    c.add_argument("--impact-dtype", default=None, choices=("int8", "int32"),
                   help="storage dtype (default: the head's dtype)")
    c.add_argument("--overwrite", action="store_true")
    c.set_defaults(fn=_compact)

    r = sub.add_parser(
        "repack", help="re-save an artifact under another docid encoding"
    )
    r.add_argument("path", help="source index artifact")
    r.add_argument("--out", required=True, help="repacked artifact directory")
    r.add_argument("--docs-format", default="packed",
                   choices=("int32", "packed"),
                   help="target docid encoding (default: packed)")
    r.add_argument("--impact-dtype", default=None, choices=("int8", "int32"),
                   help="storage dtype (default: the source's dtype)")
    r.add_argument("--overwrite", action="store_true")
    r.set_defaults(fn=_repack)

    g = sub.add_parser(
        "log", help="print the delta chain and topology-journal records"
    )
    g.add_argument("path")
    g.set_defaults(fn=_log)

    i = sub.add_parser("inspect", help="print manifest, arrays, space report")
    i.add_argument("path")
    i.add_argument("--json", action="store_true", help="dump raw manifest JSON")
    i.set_defaults(fn=_inspect)

    v = sub.add_parser("validate", help="deep-check an artifact (exit 1 if bad)")
    v.add_argument("path")
    v.set_defaults(fn=_validate)

    args = parser.parse_args(argv)
    try:
        return args.fn(args)
    except (
        artifact.ArtifactError,
        corpus_io.MissingDependencyError,
        ValueError,  # bad build/reader parameters, malformed source lines
        OSError,
    ) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
