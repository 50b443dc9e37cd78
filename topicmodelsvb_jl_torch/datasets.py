"""Synthetic corpus generators.

The reference ships the NSF abstracts corpus (128,804 docs / 25,319
vocab, README.md:34-41) and CiteULike (16,980 docs / 8,000 vocab / 5,551
users) through ``readcorp``.  The docfiles are not bundled here, so the
inputs are seeded synthetic corpora at those scales:

* :func:`synth_packed_nsf_scale` packs an NSF-scale corpus directly;
* :func:`synth_corpus` samples a :class:`~.corpus.Corpus` from the
  LDA(+readers) generative model — at ``M=16_980, V=8_000, U=5_551, K=30,
  mean_tokens=60, mean_terms=45, mean_readers=5`` it is the JAX package's
  synthetic CiteULike (``datasets.load_citeu``).

Both are copies of the JAX package's functions with the same numpy draws;
``tests/test_torch_lda.py`` and ``tests/test_torch_ctpf.py`` hold each
pair to byte-identical output for the same seed.
"""

from __future__ import annotations

import numpy as np

from .corpus import Corpus, Document
from .ops.packing import PackedCorpus, _round_up


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
