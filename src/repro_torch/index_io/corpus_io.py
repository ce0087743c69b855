"""``Corpus`` reader registry — real-collection ingestion (DESIGN.md §8).

Readers turn an external collection into the repo's bag-of-words
``data.synth.Corpus`` (CSR doc -> (term, tf)), after which the whole
pipeline — arrangement, quantization, index build, artifacts, serving — is
source-agnostic. Built-in readers run anywhere:

  * ``synth``  — the planted-topic generator (parameters as kwargs);
  * ``tsv``    — one document per line, ``doc_id<TAB>text``;
  * ``jsonl``  — one JSON object per line with ``"text"`` (tokenized) or
    pre-tokenized ``"terms"``/``"tfs"`` integer lists.

MS MARCO-scale sources are gated behind the optional ``repro[corpus]``
extra and fail with a clean ``MissingDependencyError`` when absent:

  * ``ciff``        — Common Index File Format postings
    (Lin et al., OSIRRC 2020), via ``ciff-toolkit``;
  * ``ir_datasets`` — any ``ir_datasets`` docs corpus by dataset id.

Tokenization for text readers is deliberately simple and deterministic
(lowercase alphanumeric runs, vocabulary in sorted token order): the paper
stems and stops off-line, and the traversal machinery only ever sees term
ids, so fancier analysis belongs upstream of the reader.
"""

from __future__ import annotations

import importlib.util
import json
import re
from typing import Callable, Iterable

import numpy as np

from repro_torch.data.synth import Corpus, make_corpus

__all__ = [
    "MissingDependencyError",
    "available_readers",
    "corpus_from_token_docs",
    "get_reader",
    "read_corpus",
    "register_reader",
]

_TOKEN = re.compile(r"[a-z0-9]+")

_READERS: dict[str, Callable[..., Corpus]] = {}
_OPTIONAL_DEP: dict[str, str] = {}  # reader name -> module it needs


class MissingDependencyError(ImportError):
    """An ingestion reader needs an optional dependency that is absent."""


def register_reader(name: str, requires: str | None = None):
    """Decorator: register ``fn(source, **kw) -> Corpus`` under ``name``.

    ``requires`` names a module the reader imports lazily; ``get_reader``
    then raises ``MissingDependencyError`` up front when it is missing, so
    the full test/benchmark suite stays green without the optional extra.
    """

    def deco(fn: Callable[..., Corpus]) -> Callable[..., Corpus]:
        _READERS[name] = fn
        if requires:
            _OPTIONAL_DEP[name] = requires
        return fn

    return deco


def available_readers() -> dict[str, bool]:
    """Reader name -> whether it can run in this environment."""
    return {
        name: _OPTIONAL_DEP.get(name) is None
        or importlib.util.find_spec(_OPTIONAL_DEP[name]) is not None
        for name in sorted(_READERS)
    }


def get_reader(name: str) -> Callable[..., Corpus]:
    if name not in _READERS:
        raise KeyError(
            f"unknown corpus reader {name!r}; registered: {sorted(_READERS)}"
        )
    dep = _OPTIONAL_DEP.get(name)
    if dep is not None and importlib.util.find_spec(dep) is None:
        raise MissingDependencyError(
            f"corpus reader {name!r} needs the optional module {dep!r} — "
            f"install the extra: pip install repro[corpus]"
        )
    return _READERS[name]


def read_corpus(name: str, source: str = "", **kwargs) -> Corpus:
    """Convenience: ``get_reader(name)(source, **kwargs)``."""
    return get_reader(name)(source, **kwargs)


# --------------------------------------------------------------------------
# Corpus assembly
# --------------------------------------------------------------------------


def corpus_from_token_docs(token_docs: Iterable[list[str]]) -> Corpus:
    """Build a ``Corpus`` from per-document token lists.

    Vocabulary ids are assigned in sorted token order — deterministic for a
    given collection regardless of document order of first occurrence.
    """
    docs = [d for d in token_docs]
    vocab: dict[str, int] = {
        tok: i for i, tok in enumerate(sorted({t for d in docs for t in d}))
    }
    return _assemble(
        [np.asarray([vocab[t] for t in d], np.int64) for d in docs],
        n_terms=len(vocab),
    )


def corpus_from_term_docs(
    term_docs: list[np.ndarray], n_terms: int | None = None
) -> Corpus:
    """Build a ``Corpus`` from per-document integer term-id arrays."""
    return _assemble(
        [np.asarray(d, np.int64) for d in term_docs], n_terms=n_terms
    )


def _assemble(term_docs: list[np.ndarray], n_terms: int | None) -> Corpus:
    n_docs = len(term_docs)
    if n_terms is None:
        n_terms = int(max((int(d.max()) for d in term_docs if d.size), default=-1)) + 1
    doc_ptr = np.zeros(n_docs + 1, np.int64)
    terms_out: list[np.ndarray] = []
    tfs_out: list[np.ndarray] = []
    for i, d in enumerate(term_docs):
        if d.size and (d.min() < 0 or d.max() >= n_terms):
            raise ValueError(
                f"doc {i}: term ids outside [0, {n_terms}) — bad source data"
            )
        uniq, counts = np.unique(d, return_counts=True)
        terms_out.append(uniq.astype(np.int32))
        tfs_out.append(counts.astype(np.int32))
        doc_ptr[i + 1] = doc_ptr[i] + uniq.shape[0]
    return Corpus(
        n_docs=n_docs,
        n_terms=n_terms,
        doc_ptr=doc_ptr,
        doc_terms=(
            np.concatenate(terms_out) if terms_out else np.empty(0, np.int32)
        ),
        doc_tfs=np.concatenate(tfs_out) if tfs_out else np.empty(0, np.int32),
        doc_topic=np.zeros(n_docs, np.int32),
        n_topics=1,
    )


def tokenize(text: str) -> list[str]:
    return _TOKEN.findall(text.lower())


# --------------------------------------------------------------------------
# Built-in readers (no optional deps)
# --------------------------------------------------------------------------


@register_reader("synth")
def read_synth(source: str = "", **kwargs) -> Corpus:
    """The planted-topic generator; ``source`` is unused."""
    return make_corpus(**kwargs)


@register_reader("tsv")
def read_tsv(source: str, max_docs: int | None = None) -> Corpus:
    """``doc_id<TAB>text`` per line (the MS MARCO collection.tsv shape)."""
    docs: list[list[str]] = []
    with open(source, encoding="utf-8") as f:
        for ln, line in enumerate(f, 1):
            line = line.rstrip("\n")
            if not line:
                continue
            _, sep, text = line.partition("\t")
            if not sep:
                raise ValueError(
                    f"{source}:{ln}: no tab separator — expected "
                    f"'doc_id<TAB>text' per line"
                )
            docs.append(tokenize(text))
            if max_docs is not None and len(docs) >= max_docs:
                break
    return corpus_from_token_docs(docs)


@register_reader("jsonl")
def read_jsonl(source: str, max_docs: int | None = None) -> Corpus:
    """One JSON object per line: ``{"text": …}`` or ``{"terms": …, "tfs": …}``.

    The two shapes cannot be mixed within one file — pre-tokenized term ids
    and a text-derived vocabulary would not share an id space.
    """
    token_docs: list[list[str]] = []
    term_docs: list[np.ndarray] = []
    with open(source, encoding="utf-8") as f:
        for ln, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            obj = json.loads(line)
            if "terms" in obj:
                terms = np.asarray(obj["terms"], np.int64)
                tfs = np.asarray(obj.get("tfs", np.ones(terms.shape[0])), np.int64)
                if terms.shape != tfs.shape:
                    raise ValueError(f"{source}:{ln}: terms/tfs length mismatch")
                term_docs.append(np.repeat(terms, tfs))
            elif "text" in obj:
                token_docs.append(tokenize(obj["text"]))
            else:
                raise ValueError(f"{source}:{ln}: need 'text' or 'terms'")
            if max_docs is not None and len(token_docs) + len(term_docs) >= max_docs:
                break
    if token_docs and term_docs:
        raise ValueError(f"{source}: mixes 'text' and 'terms' documents")
    if term_docs:
        return corpus_from_term_docs(term_docs)
    return corpus_from_token_docs(token_docs)


# --------------------------------------------------------------------------
# Gated readers — optional `repro[corpus]` extra
# --------------------------------------------------------------------------


@register_reader("ciff", requires="ciff_toolkit")
def read_ciff(source: str, max_docs: int | None = None) -> Corpus:
    """Common Index File Format postings -> doc-major ``Corpus``.

    CIFF ships an inverted (term-major) index; this transposes it back to
    the CSR doc -> (term, tf) layout the arrangement/build pipeline wants.
    """
    from ciff_toolkit.read import CiffReader  # noqa: PLC0415 — gated import

    term_ids: list[np.ndarray] = []
    doc_ids: list[np.ndarray] = []
    tfs: list[np.ndarray] = []
    n_docs = 0
    n_terms = 0
    with CiffReader(source) as reader:
        header = reader.read_header()
        n_docs = int(header.num_docs)
        for tid, plist in enumerate(reader.read_postings_lists()):
            n_terms = tid + 1
            docid = 0
            d, t = [], []
            for posting in plist.postings:
                docid += posting.docid  # CIFF d-gaps
                if max_docs is not None and docid >= max_docs:
                    break
                d.append(docid)
                t.append(posting.tf)
            if d:
                doc_ids.append(np.asarray(d, np.int64))
                tfs.append(np.asarray(t, np.int64))
                term_ids.append(np.full(len(d), tid, np.int64))
    if max_docs is not None:
        n_docs = min(n_docs, max_docs)
    return _transpose_postings(
        np.concatenate(term_ids) if term_ids else np.empty(0, np.int64),
        np.concatenate(doc_ids) if doc_ids else np.empty(0, np.int64),
        np.concatenate(tfs) if tfs else np.empty(0, np.int64),
        n_docs=n_docs,
        n_terms=n_terms,
    )


@register_reader("ir_datasets", requires="ir_datasets")
def read_ir_datasets(source: str, max_docs: int | None = None) -> Corpus:
    """Any ``ir_datasets`` docs corpus by dataset id (e.g. msmarco-passage)."""
    import ir_datasets  # noqa: PLC0415 — gated import

    ds = ir_datasets.load(source)
    docs: list[list[str]] = []
    for doc in ds.docs_iter():
        docs.append(tokenize(getattr(doc, "text", "") or ""))
        if max_docs is not None and len(docs) >= max_docs:
            break
    return corpus_from_token_docs(docs)


def _transpose_postings(
    term_ids: np.ndarray,
    doc_ids: np.ndarray,
    tfs: np.ndarray,
    n_docs: int,
    n_terms: int,
) -> Corpus:
    """(term, doc, tf) triples -> CSR doc-major Corpus."""
    order = np.lexsort((term_ids, doc_ids))
    doc_ids, term_ids, tfs = doc_ids[order], term_ids[order], tfs[order]
    doc_ptr = np.zeros(n_docs + 1, np.int64)
    counts = np.bincount(doc_ids, minlength=n_docs)
    doc_ptr[1:] = np.cumsum(counts)
    return Corpus(
        n_docs=n_docs,
        n_terms=n_terms,
        doc_ptr=doc_ptr,
        doc_terms=term_ids.astype(np.int32),
        doc_tfs=tfs.astype(np.int32),
        doc_topic=np.zeros(n_docs, np.int32),
        n_topics=1,
    )
