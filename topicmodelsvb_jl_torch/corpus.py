"""Host-side corpus data model and preprocessing pipeline (reference
``src/Corpus.jl``).

A pure-Python copy of the JAX package's ``corpus.py``: :class:`Document`
and :class:`Corpus` with their invariant checks (``check_doc``/
``check_corp``, Corpus.jl:41-49, 111-122), delimited-file I/O
(``readcorp``/``writecorp``, Corpus.jl:277-398), the 11 in-place corpus
mutators (Corpus.jl:406-680) and the ``fixcorp`` pipeline in the
reference's fixed order (Corpus.jl:711-730).  Importing any submodule of
the JAX package imports JAX, so the port carries its own copy;
``tests/test_torch_corpus.py`` holds the two to equal corpora, files and
printed text.
"""

from __future__ import annotations

import itertools
import warnings
from typing import Dict, Iterable, Iterator, List, Optional, Sequence

import numpy as np

from .native import parse_delimited_ints
from .utils.display import bullet, juliadots

__all__ = [
    "Document", "Corpus", "DocumentError", "CorpusError",
    "check_doc", "check_docs", "check_corp",
    "readcorp", "writecorp",
    "abridge_corp", "alphabetize_corp", "compact_corp", "condense_corp",
    "expand_corp", "pad_corp", "remove_empty_docs", "remove_redundant",
    "remove_terms", "stop_corp", "trim_corp", "trim_docs", "fixcorp",
    "showdocs", "showtitles", "getvocab", "getusers",
]


class DocumentError(Exception):
    """Mirror of the reference ``DocumentError`` (Corpus.jl:30-34)."""


class CorpusError(Exception):
    """Mirror of the reference ``CorpusError`` (Corpus.jl:85-89)."""


class Document:
    """Bag-of-words document (reference Corpus.jl:14-26).

    Fields use 1-based integer keys into the owning corpus's vocab/user
    dicts, exactly like the reference.
    """

    __slots__ = ("terms", "counts", "readers", "ratings", "title", "stamp")

    def __init__(self, terms=None, counts=None, readers=None, ratings=None,
                 title="", stamp=None):
        self.terms: List[int] = [int(t) for t in (terms or [])]
        self.counts: List[int] = (
            [int(c) for c in counts] if counts is not None else [1] * len(self.terms)
        )
        self.readers: List[int] = [int(r) for r in (readers or [])]
        self.ratings: List[int] = (
            [int(r) for r in ratings] if ratings is not None else [1] * len(self.readers)
        )
        self.title: str = title
        # optional timestamp for the dynamic topic model (v0.6 Corpus.jl:10)
        self.stamp = float(stamp) if stamp is not None else None
        check_doc(self)

    def __len__(self) -> int:
        return len(self.terms)

    @property
    def size(self) -> int:
        """Total token count Σcounts (reference ``Base.size``, Corpus.jl:126)."""
        return sum(self.counts)

    def __repr__(self) -> str:
        return f"Document with:\n * {len(self.terms)} terms\n * {len(self.readers)} readers"

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, Document)
            and self.terms == other.terms
            and self.counts == other.counts
            and self.readers == other.readers
            and self.ratings == other.ratings
            and self.title == other.title
        )

    def copy(self) -> "Document":
        return Document(
            terms=list(self.terms), counts=list(self.counts),
            readers=list(self.readers), ratings=list(self.ratings),
            title=self.title, stamp=self.stamp,
        )


def check_doc(doc: Document) -> None:
    """Document invariants (reference Corpus.jl:41-49)."""
    if not all(t > 0 for t in doc.terms):
        raise DocumentError("all terms must be positive integers.")
    if not all(c > 0 for c in doc.counts):
        raise DocumentError("all counts must be positive integers.")
    if len(doc.terms) != len(doc.counts):
        raise DocumentError("terms and counts vectors must have the same length.")
    if not all(r > 0 for r in doc.readers):
        raise DocumentError("all readers must be positive integers.")
    if not all(r > 0 for r in doc.ratings):
        raise DocumentError("all ratings must be positive integers.")
    if len(doc.readers) != len(doc.ratings):
        raise DocumentError("readers and ratings vectors must have the same length.")


class Corpus:
    """Corpus container (reference Corpus.jl:62-78).

    ``vocab`` and ``users`` are dicts of positive-int key → string, as in
    the reference; models require the keys to form 1..V / 1..U unit
    ranges (enforced by :func:`check_corp`, fixable via :func:`fixcorp`).
    """

    __slots__ = ("docs", "vocab", "users")

    def __init__(self, docs=None, vocab=None, users=None):
        self.docs: List[Document] = list(docs) if docs is not None else []
        if vocab is None:
            vocab = {}
        if isinstance(vocab, (list, tuple)):
            vocab = {k: str(t) for k, t in enumerate(vocab, start=1)}
        if users is None:
            users = {}
        if isinstance(users, (list, tuple)):
            users = {k: str(u) for k, u in enumerate(users, start=1)}
        self.vocab: Dict[int, str] = {int(k): str(v) for k, v in vocab.items()}
        self.users: Dict[int, str] = {int(k): str(v) for k, v in users.items()}

        check_docs(self)
        if not all(k > 0 for k in self.vocab):
            raise CorpusError("all vocab keys must be positive integers.")
        if not all(k > 0 for k in self.users):
            raise CorpusError("all user keys must be positive integers.")

    # ── container protocol (reference Base.* overloads, Corpus.jl:124-156) ──
    def __len__(self) -> int:
        return len(self.docs)

    def __iter__(self) -> Iterator[Document]:
        return iter(self.docs)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return self.docs[idx]
        if isinstance(idx, (list, tuple)):
            return [self.docs[i] for i in idx]
        return self.docs[idx]

    def __contains__(self, doc: Document) -> bool:
        return doc in self.docs

    def __setitem__(self, idx, value) -> None:
        """setindex! overloads (Corpus.jl:141-143): int, list, slice."""
        if isinstance(idx, (list, tuple)):
            for i, doc in zip(idx, value):
                self.docs[i] = doc
        else:
            self.docs[idx] = value

    def __delitem__(self, idx) -> None:
        """deleteat! overloads (Corpus.jl:136-138): int, list, slice."""
        if isinstance(idx, (list, tuple)):
            for i in sorted(idx, reverse=True):
                del self.docs[i]
        else:
            del self.docs[idx]

    def append(self, doc: Document) -> None:
        self.docs.append(doc)

    # push!/pop!/pushfirst!/popfirst!/insert! (Corpus.jl:132-135)
    push = append

    def pop(self, idx: int = -1) -> Document:
        return self.docs.pop(idx)

    def pushfirst(self, doc) -> None:
        if isinstance(doc, (list, tuple)):
            self.docs[:0] = list(doc)
        else:
            self.docs.insert(0, doc)

    def popfirst(self) -> Document:
        return self.docs.pop(0)

    def insert(self, d: int, doc: Document) -> None:
        self.docs.insert(d, doc)

    def findfirst(self, doc: Document):
        """0-based index of the first equal document, or None
        (Corpus.jl:147)."""
        try:
            return self.docs.index(doc)
        except ValueError:
            return None

    def findall(self, doc) -> List[int]:
        """All 0-based indices holding (any of) the given doc(s)
        (Corpus.jl:148-149)."""
        docs = doc if isinstance(doc, (list, tuple)) else [doc]
        return [i for i, d in enumerate(self.docs) if d in docs]

    @property
    def shape(self):
        """(M, V, U) — reference ``Base.size(corp)`` (Corpus.jl:152)."""
        return (len(self.docs), len(self.vocab), len(self.users))

    def copy(self) -> "Corpus":
        return Corpus(docs=list(self.docs), vocab=dict(self.vocab), users=dict(self.users))

    def deepcopy(self) -> "Corpus":
        return Corpus(
            docs=[d.copy() for d in self.docs], vocab=dict(self.vocab), users=dict(self.users)
        )

    def unique_docs(self) -> List[Document]:
        """Identity-unique docs (reference ``unique(corp)``, Corpus.jl:156).

        The reference mutators iterate ``unique(corp)`` so a document
        object shared by several corpus slots is only rewritten once.
        """
        seen: set = set()
        out: List[Document] = []
        for doc in self.docs:
            if id(doc) not in seen:
                seen.add(id(doc))
                out.append(doc)
        return out

    def __repr__(self) -> str:
        return (
            f"Corpus with:\n * {len(self.docs)} docs\n * {len(self.vocab)} vocab"
            f"\n * {len(self.users)} users"
        )


def check_docs(corp: Corpus) -> None:
    """Check every document (reference Corpus.jl:96-104)."""
    for d, doc in enumerate(corp.docs, start=1):
        try:
            check_doc(doc)
        except DocumentError as e:
            raise CorpusError(f"document {d} failed check.") from e


def check_corp(corp: Corpus) -> None:
    """Corpus invariants (reference Corpus.jl:111-122)."""
    check_docs(corp)
    if not all(k > 0 for k in corp.vocab):
        raise CorpusError("all vocab keys must be positive integers.")
    if not all(k > 0 for k in corp.users):
        raise CorpusError("all user keys must be positive integers.")
    doc_terms = set(itertools.chain.from_iterable(doc.terms for doc in corp.docs))
    doc_users = set(itertools.chain.from_iterable(doc.readers for doc in corp.docs))
    if not doc_terms <= set(corp.vocab):
        raise CorpusError(
            "documents contain term keys not found in corpus vocabulary (see fixcorp function)."
        )
    if not doc_users <= set(corp.users):
        raise CorpusError(
            "documents contain user keys not found in corpus users (see fixcorp function)."
        )
    if len(corp.vocab) != max(corp.vocab, default=0):
        raise CorpusError(
            "corpus vocab keys must form unit range starting at 1 (see fixcorp function)."
        )
    if len(corp.users) != max(corp.users, default=0):
        raise CorpusError(
            "corpus user keys must form unit range starting at 1 (see fixcorp function)."
        )


# ───────────────────────────── I/O ─────────────────────────────

def readcorp(
    docfile: str = "",
    vocabfile: str = "",
    userfile: str = "",
    titlefile: str = "",
    delim: str = ",",
    counts: bool = False,
    readers: bool = False,
    ratings: bool = False,
    stamps: bool = False,
) -> Corpus:
    """Load a corpus from delimited text files (reference Corpus.jl:277-325).

    Documents are blocks of 1–5 lines (terms / counts / readers / ratings
    / stamp); vocab and user files are tab-delimited ``key\\tname`` pairs;
    the title file is one title per line.  ``stamps`` adds a per-document
    timestamp line for the dynamic topic model (v0.6 Corpus.jl:47-62).
    Integer docfiles go through the native parser when it builds, else
    through the pure-Python one; both give equal corpora, and
    ``readcorp.route`` (``"native"`` or ``"python"``) says which read the
    last docfile.
    """
    if ratings and not readers:
        ratings = False
        warnings.warn("ratings require readers, ratings switch set to false.")
    if not docfile and titlefile:
        warnings.warn("no docfile, titles will not be assigned.")

    corp = Corpus()
    if docfile:
        block = 1 + counts + readers + ratings + stamps
        keys = [k for k, on in zip(
            ("terms", "counts", "readers", "ratings", "stamp"),
            (True, counts, readers, ratings, stamps),
        ) if on]
        parsed = None
        if not stamps:  # stamp lines are floats; the native parser is integer-only
            with open(docfile, "rb") as fb:
                data = fb.read()
            try:
                parsed = parse_delimited_ints(data, delim)
            except ValueError:
                # the native grammar is a strict subset of int()'s ('+5',
                # 20-digit values): the pure-Python parser below decides
                parsed = None
        readcorp.route = "python" if parsed is None else "native"
        if parsed is not None:
            # native C++ byte-level parse (native/tmvb_native.cpp); doc
            # blocks are sliced out of the CSR (values, line-offsets) form
            vals, offs = parsed
            n_lines = len(offs) - 1
            for d in range(0, n_lines, block):
                try:
                    fields = {
                        k: vals[offs[d + j] : offs[d + j + 1]].tolist()
                        for j, k in enumerate(keys) if d + j < n_lines
                    }
                    corp.append(Document(**fields))
                except Exception as e:
                    raise CorpusError(
                        f"document {d // block + 1} beginning on line {d + 1} failed to load."
                    ) from e
        else:
            with open(docfile) as f:
                lines = f.read().splitlines()
            for d in range(0, len(lines), block):
                doc_block = lines[d : d + block]
                try:
                    fields = {
                        k: (float(line) if k == "stamp"
                            else [int(p) for p in line.split(delim)] if line else [])
                        for k, line in zip(keys, doc_block)
                    }
                    corp.append(Document(**fields))
                except Exception as e:
                    raise CorpusError(
                        f"document {d // block + 1} beginning on line {d + 1} failed to load."
                    ) from e
    else:
        warnings.warn("no docfile, topic models cannot be trained without documents.")

    if vocabfile:
        vocab: Dict[int, str] = {}
        with open(vocabfile) as f:
            for line in f:
                line = line.rstrip("\n")
                if not line:
                    continue
                k, _, t = line.partition("\t")
                vocab[int(k)] = t
        if not all(k > 0 for k in vocab):
            raise CorpusError("all vocab keys must be positive integers.")
        corp.vocab = vocab

    if userfile:
        users: Dict[int, str] = {}
        with open(userfile) as f:
            for line in f:
                line = line.rstrip("\n")
                if not line:
                    continue
                k, _, u = line.partition("\t")
                users[int(k)] = u
        if not all(k > 0 for k in users):
            raise CorpusError("all user keys must be positive integers.")
        corp.users = users

    if titlefile:
        with open(titlefile) as f:
            titles = f.read().splitlines()
        for doc, title in zip(corp.docs, titles):
            doc.title = title

    return corp


readcorp.route = None   # "native" or "python": the parser of the last docfile read


def writecorp(
    corp: Corpus,
    docfile: str = "",
    vocabfile: str = "",
    userfile: str = "",
    titlefile: str = "",
    delim: str = ",",
    counts: bool = False,
    readers: bool = False,
    ratings: bool = False,
    stamps: bool = False,
) -> None:
    """Write a corpus to text files (reference Corpus.jl:366-398;
    ``stamps`` per v0.6 Corpus.jl:93-108)."""
    if ratings and not readers:
        ratings = False
        warnings.warn("ratings require readers, ratings switch set to false.")

    if docfile:
        attrs = [a for a, on in (("counts", counts), ("readers", readers), ("ratings", ratings)) if on]
        if stamps and any(doc.stamp is None for doc in corp.docs):
            raise CorpusError(
                "stamps=True requires every document to carry a stamp — "
                "a written 'None' line could not be read back.")
        with open(docfile, "w") as f:
            for doc in corp.docs:
                f.write(delim.join(map(str, doc.terms)) + "\n")
                for a in attrs:
                    f.write(delim.join(map(str, getattr(doc, a))) + "\n")
                if stamps:
                    f.write(f"{doc.stamp}\n")

    if vocabfile:
        with open(vocabfile, "w") as f:
            for k in sorted(corp.vocab):
                f.write(f"{k}\t{corp.vocab[k]}\n")

    if userfile:
        with open(userfile, "w") as f:
            for k in sorted(corp.users):
                f.write(f"{k}\t{corp.users[k]}\n")

    if titlefile:
        with open(titlefile, "w") as f:
            for doc in corp.docs:
                f.write(doc.title + "\n")


# ───────────────────── corpus mutators (Corpus.jl:406-680) ─────────────────────

def abridge_corp(corp: Corpus, n: int = 0) -> None:
    """Remove terms appearing < n times corpus-wide (Corpus.jl:411-425)."""
    vocab_count: Dict[int, int] = {}
    for doc in corp.unique_docs():
        for j, c in zip(doc.terms, doc.counts):
            vocab_count[j] = vocab_count.get(j, 0) + c
    for doc in corp.unique_docs():
        keep = [vocab_count[j] >= n for j in doc.terms]
        doc.terms = [j for j, k in zip(doc.terms, keep) if k]
        doc.counts = [c for c, k in zip(doc.counts, keep) if k]


def alphabetize_corp(corp: Corpus, vocab: bool = True, users: bool = True) -> None:
    """Alphabetize vocab/user dicts, remapping doc keys (Corpus.jl:432-457)."""
    if vocab and corp.vocab:
        vkeys = sorted(corp.vocab)
        names = [corp.vocab[k] for k in vkeys]
        order = np.argsort(np.argsort(names, kind="stable"), kind="stable")
        vkey_map = {old: vkeys[order[i]] for i, old in enumerate(vkeys)}
        corp.vocab = dict(zip(vkeys, sorted(names)))
        for doc in corp.unique_docs():
            doc.terms = [vkey_map[j] for j in doc.terms]

    if users and corp.users:
        ukeys = sorted(corp.users)
        names = [corp.users[k] for k in ukeys]
        order = np.argsort(np.argsort(names, kind="stable"), kind="stable")
        ukey_map = {old: ukeys[order[i]] for i, old in enumerate(ukeys)}
        corp.users = dict(zip(ukeys, sorted(names)))
        for doc in corp.unique_docs():
            doc.readers = [ukey_map[r] for r in doc.readers]


def remove_terms(corp: Corpus, terms: Sequence[str]) -> None:
    """Remove the named terms from all documents (Corpus.jl:473-482)."""
    targets = {t.lower() for t in terms}
    remove_keys = {k for k, t in corp.vocab.items() if t.lower() in targets}
    for doc in corp.unique_docs():
        keep = [j not in remove_keys for j in doc.terms]
        doc.terms = [j for j, k in zip(doc.terms, keep) if k]
        doc.counts = [c for c, k in zip(doc.counts, keep) if k]


def compact_corp(corp: Corpus, vocab: bool = True, users: bool = True) -> None:
    """Relabel keys to unit ranges 1..V / 1..U (Corpus.jl:495-516)."""
    if vocab:
        vkey_map = {k: i for i, k in enumerate(sorted(corp.vocab), start=1)}
        corp.vocab = {vkey_map[k]: t for k, t in corp.vocab.items()}
        for doc in corp.unique_docs():
            doc.terms = [vkey_map[j] for j in doc.terms]
    if users:
        ukey_map = {k: i for i, k in enumerate(sorted(corp.users), start=1)}
        corp.users = {ukey_map[k]: u for k, u in corp.users.items()}
        for doc in corp.unique_docs():
            doc.readers = [ukey_map[r] for r in doc.readers]


def condense_corp(corp: Corpus) -> None:
    """Merge duplicate term occurrences, summing counts (Corpus.jl:523-534)."""
    for doc in corp.unique_docs():
        dd: Dict[int, int] = {}
        for j, c in zip(doc.terms, doc.counts):
            dd[j] = dd.get(j, 0) + c
        doc.terms = list(dd.keys())
        doc.counts = list(dd.values())


def expand_corp(corp: Corpus) -> None:
    """Inverse of :func:`condense_corp`: one entry per token (all counts
    1), repeats adjacent.  This is the order-preserving form HMTM
    consumes (it reads ``terms`` as the document's token sequence,
    reference HMTM.jl:63-67).  For a corpus read with ``counts=True``
    (or condensed), the original word order is already gone — expansion
    places repeats adjacently, which is the only order the data still
    determines; corpora read token-per-line keep their true order."""
    for doc in corp.unique_docs():
        terms = [t for t, c in zip(doc.terms, doc.counts)
                 for _ in range(int(c))]
        doc.terms = terms
        doc.counts = [1] * len(terms)


def pad_corp(corp: Corpus, vocab: bool = True, users: bool = True) -> None:
    """Add generic entries for keys in docs but missing from dicts (Corpus.jl:541-556)."""
    if vocab:
        doc_vkeys = set(itertools.chain.from_iterable(doc.terms for doc in corp.docs))
        for k in doc_vkeys - set(corp.vocab):
            corp.vocab[k] = f"#term{k}"
    if users:
        doc_ukeys = set(itertools.chain.from_iterable(doc.readers for doc in corp.docs))
        for k in doc_ukeys - set(corp.users):
            corp.users[k] = f"#user{k}"


def remove_empty_docs(corp: Corpus) -> None:
    """Drop documents with no terms (Corpus.jl:563-567)."""
    corp.docs = [doc for doc in corp.docs if len(doc) > 0]


def remove_redundant(corp: Corpus, vocab: bool = True, users: bool = True) -> None:
    """Merge keys mapping to duplicate names (Corpus.jl:574-615)."""
    if vocab:
        vkey_map: Dict[int, int] = {}
        inverse: Dict[str, int] = {}
        for k in sorted(corp.vocab):
            name = corp.vocab[k]
            if name in inverse:
                vkey_map[k] = inverse[name]
                del corp.vocab[k]
            else:
                vkey_map[k] = k
                inverse[name] = k
        for doc in corp.unique_docs():
            doc.terms = [vkey_map[j] for j in doc.terms]
    if users:
        ukey_map: Dict[int, int] = {}
        inverse = {}
        for k in sorted(corp.users):
            name = corp.users[k]
            if name in inverse:
                ukey_map[k] = inverse[name]
                del corp.users[k]
            else:
                ukey_map[k] = k
                inverse[name] = k
        for doc in corp.unique_docs():
            doc.readers = [ukey_map[r] for r in doc.readers]


def stop_corp(corp: Corpus, stop_words: Optional[Iterable[str]] = None) -> None:
    """Remove stop words (Corpus.jl:622-634); default bundled list."""
    if stop_words is None:
        from .datasets import load_stopwords

        stop_words = load_stopwords()
    stops = {w.lower() for w in stop_words}
    stop_keys = {k for k, t in corp.vocab.items() if t.lower() in stops}
    for doc in corp.unique_docs():
        keep = [j not in stop_keys for j in doc.terms]
        doc.terms = [j for j, k in zip(doc.terms, keep) if k]
        doc.counts = [c for c, k in zip(doc.counts, keep) if k]


def trim_corp(corp: Corpus, vocab: bool = True, users: bool = True) -> None:
    """Drop dict keys not used by any document (Corpus.jl:641-652)."""
    if vocab:
        doc_vkeys = set(itertools.chain.from_iterable(doc.terms for doc in corp.docs))
        corp.vocab = {k: t for k, t in corp.vocab.items() if k in doc_vkeys}
    if users:
        doc_ukeys = set(itertools.chain.from_iterable(doc.readers for doc in corp.docs))
        corp.users = {k: u for k, u in corp.users.items() if k in doc_ukeys}


def trim_docs(corp: Corpus, terms: bool = True, readers: bool = True) -> None:
    """Remove doc keys that are missing from the dicts (Corpus.jl:659-680)."""
    if terms:
        doc_vkeys = set(itertools.chain.from_iterable(doc.terms for doc in corp.docs))
        bogus = doc_vkeys - set(corp.vocab)
        for doc in corp.unique_docs():
            keep = [j not in bogus for j in doc.terms]
            doc.terms = [j for j, k in zip(doc.terms, keep) if k]
            doc.counts = [c for c, k in zip(doc.counts, keep) if k]
    if readers:
        doc_ukeys = set(itertools.chain.from_iterable(doc.readers for doc in corp.docs))
        bogus = doc_ukeys - set(corp.users)
        for doc in corp.unique_docs():
            keep = [u not in bogus for u in doc.readers]
            doc.readers = [u for u, k in zip(doc.readers, keep) if k]
            doc.ratings = [r for r, k in zip(doc.ratings, keep) if k]


# module-function aliases: fixcorp's reference-spelled kwargs
# (fixcorp!(corp, remove_empty_docs=true), Corpus.jl:711) shadow the
# mutator functions of the same name inside its body
_remove_empty_docs_fn = remove_empty_docs
_remove_redundant_fn = remove_redundant
_remove_terms_fn = remove_terms


def fixcorp(
    corp: Corpus,
    vocab: bool = True,
    users: bool = True,
    abridge: int = 0,
    alphabetize: bool = False,
    condense: bool = False,
    pad: bool = False,
    remove_empty_docs: bool = False,
    remove_redundant: bool = False,
    remove_terms: Sequence[str] = (),
    stop: bool = False,
    trim: bool = False,
) -> None:
    """Master preprocessing pipeline, fixed order (reference Corpus.jl:711-730).

    Order: pad|trim_docs → remove_redundant → condense → abridge →
    remove_terms → stop → trim → alphabetize → remove_empty_docs →
    compact.  Matching this order exactly matters: it silently changes
    every downstream number otherwise.
    """
    check_docs(corp)
    if not all(k > 0 for k in corp.vocab):
        raise CorpusError("all vocab keys must be positive integers.")
    if not all(k > 0 for k in corp.users):
        raise CorpusError("all user keys must be positive integers.")

    if pad:
        pad_corp(corp)
    else:
        trim_docs(corp)

    if remove_redundant:
        _remove_redundant_fn(corp)
    if condense:
        condense_corp(corp)
    if abridge > 0:
        abridge_corp(corp, abridge)
    if remove_terms:
        _remove_terms_fn(corp, remove_terms)
    if stop:
        stop_corp(corp)
    if trim:
        trim_corp(corp, vocab=vocab, users=users)
    if alphabetize:
        alphabetize_corp(corp, vocab=vocab, users=users)
    if remove_empty_docs:
        _remove_empty_docs_fn(corp)

    compact_corp(corp)


# ───────────────────── display helpers (Corpus.jl:163-270) ─────────────────────

def getvocab(corp: Corpus) -> List[str]:
    return sorted(corp.vocab.values())


def getusers(corp: Corpus) -> List[str]:
    return sorted(corp.users.values())


def showdocs(corp: Corpus, docs=None) -> None:
    """Print document(s) in readable form (reference Corpus.jl:163-214)."""
    if docs is None:
        docs = range(1, len(corp) + 1)
    if isinstance(docs, (int, Document)):
        docs = [docs]
    items = list(docs)
    for n, item in enumerate(items):
        if isinstance(item, Document):
            doc, label = item, item.title or "Document"
            juliadots(f"{label}\n")
        else:
            d = int(item)
            if not 1 <= d <= len(corp):
                raise CorpusError("some document indices outside corpus range.")
            doc = corp.docs[d - 1]
            juliadots(f"Document {d}\n")
            if doc.title:
                juliadots(f"{doc.title}\n")
        if not set(doc.terms) <= set(corp.vocab):
            raise DocumentError("some documents contain term keys not found in corpus vocabulary.")
        print(" ".join(corp.vocab[j] for j in doc.terms) if len(doc) else "")
        if n < len(items) - 1:
            print()


def showtitles(corp: Corpus, docs=None) -> None:
    """Print document title(s) (reference Corpus.jl:221-256)."""
    if docs is None:
        docs = range(1, len(corp) + 1)
    if isinstance(docs, (int, Document)):
        docs = [docs]
    for item in docs:
        if isinstance(item, Document):
            bullet(item.title or "Document")
        else:
            d = int(item)
            if not 1 <= d <= len(corp):
                raise CorpusError("some document indices outside corpus range.")
            doc = corp.docs[d - 1]
            bullet(f"Document {d} {doc.title}" if doc.title else f"Document {d}")
