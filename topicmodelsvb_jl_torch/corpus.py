"""Host-side corpus containers (reference ``src/Corpus.jl``).

A pure-Python copy of the JAX package's ``corpus.py`` containers:
:class:`Document` and :class:`Corpus` with their invariant checks
(Corpus.jl:41-49, 96-104), ``shape`` and ``copy``.  Importing any
submodule of the JAX package imports JAX, so the port carries its own
copy.  The corpus mutators, ``fixcorp`` and ``readcorp`` are not here
yet; models take a :class:`~.ops.packing.PackedCorpus`
(``ops/packing.pack_corpus``).
"""

from __future__ import annotations

from typing import Dict, Iterator, List

__all__ = ["Document", "Corpus", "DocumentError", "CorpusError",
           "check_doc", "check_docs"]


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
