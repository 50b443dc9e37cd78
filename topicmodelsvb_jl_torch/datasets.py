"""Bundled word lists, dataset loaders and synthetic corpus generators.

The reference ships the NSF abstracts corpus (128,804 docs / 25,319
vocab, README.md:34-41) and CiteULike (16,980 docs / 8,000 vocab / 5,551
users), loadable through ``readcorp(:nsf)``/``readcorp(:citeu)``
(Corpus.jl:337-359), and the v0.6 mac corpus.  Their docfiles are not
bundled, so:

* :func:`load_nsf`, :func:`load_citeu` and :func:`load_mac` read the real
  files from the directory ``TMVB_DATASETS`` names, when it holds them,
  and otherwise synthesize documents at the published scale, seeded;
* :func:`synth_packed_nsf_scale` packs an NSF-scale corpus directly;
* :func:`synth_corpus` samples a :class:`~.corpus.Corpus` from the
  LDA(+readers) generative model.

All are copies of the JAX package's functions with the same numpy draws
(its loaders also look for one fixed reference checkout, which the port
does not); ``tests/test_torch_corpus.py``, ``tests/test_torch_lda.py``
and ``tests/test_torch_ctpf.py`` hold each pair to equal output for the
same seed.  The stop list and the English word list are copies of the
JAX package's ``data/`` files, byte for byte.
"""

from __future__ import annotations

import os
import warnings
from typing import Optional

import numpy as np

from .corpus import Corpus, Document, readcorp
from .ops.packing import PackedCorpus, _round_up

_DATA_DIR = os.path.join(os.path.dirname(__file__), "data")

# Published corpus scales (reference README.md:34-41; mac from the v0.6
# dataset files: 75,011 titles / 15,113-term lexicon).
NSF_SCALE = dict(M=128_804, V=25_319)
CITEU_SCALE = dict(M=16_980, V=8_000, U=5_551)
MAC_SCALE = dict(M=75_011, V=15_113, T=12)


def load_stopwords() -> list:
    """The reference's exact stop list (datasets/stopwords.txt — 546
    lines of which one is blank, i.e. 545 words; consumed by stop_corp!,
    Corpus.jl:622-634), carried byte for byte so the preprocessing
    pipeline produces identical corpora."""
    with open(os.path.join(_DATA_DIR, "stopwords.txt")) as f:
        return [w for w in f.read().split() if w]


def load_englishwords() -> list:
    """The reference's 58,110-entry English word list
    (datasets/englishwords.txt), bundled for vocabulary filtering."""
    with open(os.path.join(_DATA_DIR, "englishwords.txt")) as f:
        return [w for w in f.read().split() if w]


def _datasets_root() -> Optional[str]:
    root = os.environ.get("TMVB_DATASETS")
    if root and os.path.isdir(root):
        return root
    return None


def _read_kv_file(path: str) -> dict:
    out = {}
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            k, _, v = line.partition("\t")
            out[int(k)] = v
    return out


def load_nsf(seed: int = 7, subset: Optional[int] = None) -> Corpus:
    """NSF abstracts corpus (reference ``readcorp(:nsf)``, Corpus.jl:340-344)."""
    root = _datasets_root()
    docfile = os.path.join(root, "nsf", "nsfdocs.txt") if root else ""
    vocabfile = os.path.join(root, "nsf", "nsfvocab.txt") if root else ""
    titlefile = os.path.join(root, "nsf", "nsftitles.txt") if root else ""

    if docfile and os.path.exists(docfile):
        corp = readcorp(
            docfile=docfile,
            vocabfile=vocabfile,
            titlefile=titlefile if os.path.exists(titlefile) else "",
            counts=True,
        )
        if subset:
            corp.docs = corp.docs[:subset]
        return corp

    vocab = _read_kv_file(vocabfile) if vocabfile and os.path.exists(vocabfile) else None
    V = max(vocab) if vocab else NSF_SCALE["V"]
    M = subset or NSF_SCALE["M"]
    warnings.warn(
        "NSF docfile not available; generating a synthetic "
        f"corpus at reference scale (M={M}, V={V}, seed={seed})."
    )
    corp = synth_corpus(M=M, V=V, K=50, seed=seed, mean_tokens=120, mean_terms=85)
    if vocab:
        corp.vocab = dict(vocab)
    return corp


def load_citeu(seed: int = 7, subset: Optional[int] = None) -> Corpus:
    """CiteULike corpus (reference ``readcorp(:citeu)``, Corpus.jl:346-351)."""
    root = _datasets_root()
    base = os.path.join(root, "citeu") if root else ""
    docfile = os.path.join(base, "citeudocs.txt") if base else ""
    vocabfile = os.path.join(base, "citeuvocab.txt") if base else ""
    userfile = os.path.join(base, "citeuusers.txt") if base else ""
    titlefile = os.path.join(base, "citeutitles.txt") if base else ""

    if docfile and os.path.exists(docfile):
        corp = readcorp(
            docfile=docfile, vocabfile=vocabfile, userfile=userfile,
            titlefile=titlefile if os.path.exists(titlefile) else "", counts=True,
            readers=True,
        )
        if subset:
            corp.docs = corp.docs[:subset]
        return corp

    vocab = _read_kv_file(vocabfile) if vocabfile and os.path.exists(vocabfile) else None
    users = _read_kv_file(userfile) if userfile and os.path.exists(userfile) else None
    V = max(vocab) if vocab else CITEU_SCALE["V"]
    U = max(users) if users else CITEU_SCALE["U"]
    M = subset or CITEU_SCALE["M"]
    if subset:
        # scale the user pool with the doc subset so reads-per-user
        # density stays at CiteULike's (~12): keeping all 5.5k users
        # over a few hundred docs would leave most users with a single
        # read, making recommender evaluation degenerate.  Never scale
        # ABOVE the users file's id range: a reader id with no name
        # entry would break every user-display path.
        scaled = max(10, round(U * M / CITEU_SCALE["M"]))
        U = min(U, scaled) if users else scaled
    warnings.warn(
        "CiteULike docfile not available; generating a synthetic "
        f"corpus at reference scale (M={M}, V={V}, U={U}, seed={seed})."
    )
    corp = synth_corpus(
        M=M, V=V, U=U, K=30, seed=seed, mean_tokens=60, mean_terms=45, mean_readers=5
    )
    if vocab:
        corp.vocab = dict(vocab)
    if users:
        corp.users = {k: v for k, v in users.items() if k <= U}
    return corp


def load_mac(seed: int = 7, subset: Optional[int] = None) -> Corpus:
    """Macintosh magazine corpus (v0.6 ``readcorp(:mac)``,
    v0.6/src/Corpus.jl:429-434) — the time-stamped DTM dataset.

    Reads the real files (maclex.txt vocab, mactitles.txt titles,
    macdocs.txt doc blocks with counts+stamps) when a datasets directory
    is available; otherwise a time-sliced synthetic corpus is generated at
    the published scale against the real lexicon, where there is one.
    """
    root = _datasets_root()
    base = os.path.join(root, "mac") if root else ""
    docfile = os.path.join(base, "macdocs.txt") if base else ""
    vocabfile = os.path.join(base, "maclex.txt") if base else ""
    titlefile = os.path.join(base, "mactitles.txt") if base else ""

    if docfile and os.path.exists(docfile):
        corp = readcorp(
            docfile=docfile, vocabfile=vocabfile,
            titlefile=titlefile if os.path.exists(titlefile) else "",
            counts=True, stamps=True,
        )
        if subset:
            corp.docs = corp.docs[:subset]
        return corp

    vocab = _read_kv_file(vocabfile) if vocabfile and os.path.exists(vocabfile) else None
    titles = None
    if titlefile and os.path.exists(titlefile):
        with open(titlefile) as f:
            titles = f.read().splitlines()
    V = max(vocab) if vocab else MAC_SCALE["V"]
    M = subset or (len(titles) if titles else MAC_SCALE["M"])
    warnings.warn(
        "mac docfile not available; generating a synthetic "
        f"time-sliced corpus at reference scale (M={M}, V={V}, seed={seed})."
    )
    corp = synth_corpus(M=M, V=V, K=20, seed=seed, mean_tokens=400,
                        mean_terms=220, n_slices=MAC_SCALE["T"], drift=0.05)
    if vocab:
        corp.vocab = dict(vocab)
    if titles:
        for doc, title in zip(corp.docs, titles):
            doc.title = title
    return corp


def synth_packed_nsf_scale(M=128_804, V=25_319, mean_terms=85, seed=7,
                           chunk_docs=1024, pad_multiple=32,
                           dtype=np.float32, skew: float = 3.0):
    """Vectorised synthetic corpus at NSF scale, packed directly.

    Zipf-like vocab draw (u^skew skews mass to low ids), Poisson doc
    lengths clipped at 8 terms, seed-controlled; returns a dense
    PackedCorpus suitable for ``LDA(packed, K)`` or bucketize_packed."""
    rng = np.random.default_rng(seed)
    N = np.clip(rng.poisson(mean_terms, size=M), 8, None).astype(np.int32)
    L = _round_up(int(N.max()), pad_multiple)
    M_pad = -(-M // chunk_docs) * chunk_docs

    u = rng.random((M_pad, L), dtype=np.float32)
    terms = np.minimum((V * u**skew).astype(np.int32), V - 1)
    tok_idx = np.arange(L, dtype=np.int32)[None, :]
    N_full = np.zeros(M_pad, np.int32)
    N_full[:M] = N
    valid = tok_idx < N_full[:, None]
    counts = (1 + rng.poisson(0.35, size=(M_pad, L))).astype(dtype) * valid
    terms = terms * valid
    doc_mask = np.zeros(M_pad, dtype)
    doc_mask[:M] = 1.0
    return PackedCorpus(
        terms=terms, counts=counts, doc_mask=doc_mask, N=N_full,
        C=counts.sum(1).astype(dtype), M=M, V=V, L=L,
        max_count=int(counts.max()),
    )


def synth_corpus(
    M: int,
    V: int,
    K: int = 10,
    U: int = 0,
    seed: int = 0,
    mean_tokens: float = 60.0,
    mean_terms: float = 40.0,
    mean_readers: float = 4.0,
    alpha: float = 0.5,
    topic_concentration: float = 0.1,
    n_slices: int = 0,
    drift: float = 0.0,
) -> Corpus:
    """Sample a corpus from the LDA(+readers) generative model.

    Vectorised sampler: per-doc theta ~ Dir(alpha), topic-word rows
    ~ Dir(topic_concentration); documents get ~mean_terms unique terms
    with counts summing to ~mean_tokens.  Readers (for CTPF) follow the
    CTPF generative story: each user carries a sharp topic-preference
    vector and a Zipf-distributed activity level, and reads documents
    with probability ∝ activity · preference·theta (ratings=1,
    matching CiteULike's binary structure).  The power-law activity
    mirrors real citation data's concentrated libraries (reference
    README.md:541-580: CiteULike yields top ~2% held-out ranks) — so
    reader lists are content-correlated and leave-one-reader-out
    evaluation (evaluate.holdout_readers) behaves as on the real data.
    """
    rng = np.random.default_rng(seed)
    beta = rng.dirichlet(np.full(V, topic_concentration), size=K)  # [K, V]
    thetas = rng.dirichlet(np.full(K, alpha), size=M)              # [M, K]
    user_pref = (rng.dirichlet(np.full(K, 0.1), size=U)            # [U, K]
                 if U > 0 else None)
    user_act = (1.0 / (rng.permutation(U) + 1.0) ** 1.2
                if U > 0 else None)

    # optional time structure (for DTM): per-slice drifting topics via a
    # Gaussian random walk on log beta, and uniform stamps in [0, n_slices)
    stamps = None
    beta_t = None
    if n_slices > 0:
        stamps = rng.uniform(0, n_slices, size=M)
        logb = np.log(beta + 1e-12)
        beta_t = []
        for _ in range(n_slices):
            logb = logb + drift * rng.standard_normal((K, V))
            e = np.exp(logb - logb.max(axis=1, keepdims=True))
            beta_t.append(e / e.sum(axis=1, keepdims=True))

    docs = []
    n_terms = np.clip(rng.poisson(mean_terms, size=M), 1, V)
    extra = np.maximum(mean_tokens - mean_terms, 1.0)
    for d in range(M):
        bd = beta if beta_t is None else beta_t[min(int(stamps[d]), n_slices - 1)]
        mix = thetas[d] @ bd  # [V]
        nt = int(n_terms[d])
        terms0 = rng.choice(V, size=nt, replace=False, p=mix)
        counts = 1 + rng.poisson(extra / nt, size=nt)
        doc = Document(terms=(terms0 + 1).tolist(), counts=counts.tolist(),
                       stamp=None if stamps is None else float(stamps[d]))
        if U > 0:
            nr = min(int(rng.poisson(mean_readers)) + 1, U)
            w = user_act * (user_pref @ thetas[d])
            readers0 = rng.choice(U, size=nr, replace=False, p=w / w.sum())
            doc.readers = (readers0 + 1).tolist()
            doc.ratings = [1] * nr
        docs.append(doc)

    vocab = {j + 1: f"term{j + 1}" for j in range(V)}
    users = {u + 1: f"user{u + 1}" for u in range(U)} if U > 0 else {}
    return Corpus(docs=docs, vocab=vocab, users=users)
