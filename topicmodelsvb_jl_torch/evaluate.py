"""Model evaluation metrics, beyond the reference's capability surface.

A copy of the JAX package's ``evaluate.py`` for the port's models:

* :func:`perplexity`: held-out per-word predictive perplexity
  ``exp(−Σ log p(w|d) / Σ counts)``, with the document-topic posterior
  inferred by :func:`~.api.predict` (theta inferred on the scored
  tokens: the common "direct" estimate).
* :func:`topic_coherence`: UMass coherence (Mimno et al. 2011),
  ``C_k = Σ_{i<j≤N} log[(D(w_i, w_j) + 1) / D(w_j)]`` over each topic's
  top-N words, with document (co-)occurrence counts from a reference
  corpus.  Higher (closer to 0) is better.
* :func:`holdout_readers` / :func:`heldout_reader_rank` /
  :func:`recall_at_k`: the leave-one-reader-out recommender protocol the
  reference demonstrates by hand (README.md:512-560, plots.R:20-31).

Scoring runs on the host in NumPy f64, as in the JAX package.
"""

from __future__ import annotations

import itertools
from typing import Optional

import numpy as np

from .api import CTM, HMTM, LDA, fCTM, fLDA, predict
from .corpus import Corpus


def perplexity(corp: Corpus, train_model, iter: int = 10,
               tol: Optional[float] = None, chunk: int = 4096) -> float:
    """Held-out per-word perplexity of ``corp`` under ``train_model``.

    Defined for LDA, fLDA, CTM and fCTM (the models with a document-topic
    simplex and a topic-word matrix) and HMTM.  fLDA and fCTM use the full
    mixture ``eta·(θβ)_w + (1−eta)·κ_w`` (fLDA.jl's generative story).
    HMTM is order-aware: each held-out document is scored by the HMM
    forward algorithm under its fitted posterior means.

    Scores from the packed dense arrays, one beta gather and einsum per
    ``chunk`` documents, padding masked by counts, in f64; never the dense
    [M, V] mixture.
    """
    if not isinstance(train_model, (LDA, fLDA, CTM, fCTM, HMTM)):
        raise TypeError(f"perplexity is not defined for {type(train_model).__name__}")
    pred = predict(corp, train_model, iter=iter, tol=tol)
    if isinstance(train_model, HMTM):
        return _hmtm_perplexity(train_model, pred, chunk)

    beta = np.asarray(train_model.beta, np.float64)        # [K, V]
    rows = pred._doc_rows()
    theta = np.asarray(pred._topicdist_rows(rows), np.float64)  # [M, K]
    filtered = isinstance(train_model, (fLDA, fCTM))
    if filtered:
        eta = float(train_model.eta)
        kappa = np.asarray(train_model.kappa, np.float64)

    # doc-order packed views (bucketize keeps the dense copies)
    p = pred.packed
    terms = p.terms[rows]                                   # [M, L] 0-based
    counts = p.counts[rows].astype(np.float64)              # 0 on padding

    ll = 0.0
    n_tokens = 0.0
    for lo in range(0, terms.shape[0], chunk):
        t = terms[lo:lo + chunk]
        c = counts[lo:lo + chunk]
        mix = np.einsum("bk,kbl->bl", theta[lo:lo + chunk], beta[:, t])
        if filtered:
            mix = eta * mix + (1.0 - eta) * kappa[t]
        mix = np.maximum(mix, 1e-300)
        live = c > 0
        ll += float(np.sum(c * np.log(np.where(live, mix, 1.0)), where=live))
        n_tokens += float(c.sum())
    if n_tokens == 0:
        raise ValueError("perplexity needs at least one token.")
    return float(np.exp(-ll / n_tokens))


def _hmtm_perplexity(train_model, pred, chunk: int) -> float:
    """Plug-in HMM forward likelihood of each document's ordered tokens,
    p(w_1..w_N) with pi = E_q[pi_d], A = E_q[theta_d] and emissions beta,
    over the documents in f64; the token axis is a loop at the held-out
    corpus's padded width.  One token is one terms entry, as in training
    (HMTM.jl:63-67): counts give only the padding mask."""
    rows = pred._doc_rows()
    tau = np.asarray(pred.state.tau.detach().cpu(), np.float64)[rows]        # [M, K]
    gamma = np.asarray(pred.state.gamma.detach().cpu(), np.float64)[rows]    # [M, K, K]
    pi = tau / tau.sum(-1, keepdims=True)
    A = gamma / gamma.sum(-2, keepdims=True)
    betaT = np.asarray(train_model.beta, np.float64).T + 1e-300             # [V, K]

    p = pred.packed
    terms = p.terms[rows]
    counts = p.counts[rows]

    ll = 0.0
    n_tokens = 0.0
    for lo in range(0, terms.shape[0], chunk):
        t = terms[lo:lo + chunk]
        live = counts[lo:lo + chunk] > 0                        # [B, L]
        Bv = betaT[t]                                           # [B, L, K]
        a = pi[lo:lo + chunk]
        for n in range(t.shape[1]):
            f = Bv[:, n] * (a if n == 0 else np.einsum("bil,bl->bi", A[lo:lo + chunk], a))
            c = np.maximum(f.sum(-1), 1e-300)
            a = np.where(live[:, n, None], f / c[:, None], a)
            ll += float(np.sum(np.log(c), where=live[:, n]))
        n_tokens += float(live.sum())
    if n_tokens == 0:
        raise ValueError("perplexity needs at least one token.")
    return float(np.exp(-ll / n_tokens))


def topic_coherence(model, N: int = 10, corp: Optional[Corpus] = None) -> np.ndarray:
    """UMass coherence per topic over the top-``N`` words.

    ``corp`` defaults to the model's training corpus; pass one
    explicitly for models built from a PackedCorpus.
    """
    corp = corp if corp is not None else model.corp
    if corp is None:
        raise ValueError("topic_coherence needs a Corpus (the model was built from "
                         "a PackedCorpus; pass corp=...).")
    if N < 2:
        raise ValueError("N must be at least 2.")
    if model.topics is None:
        raise ValueError("train the model first (topics ranking unset).")

    K = model.K
    top = np.asarray(model.topics)[:, :N]                  # 1-based ids
    need = sorted({int(w) for row in top for w in row})
    col = {w: j for j, w in enumerate(need)}
    # doc-incidence matrix for just the needed words, one flat pass over
    # the corpus (a per-token Python loop is minutes at 100k documents)
    M = len(corp.docs)
    inc = np.zeros((M, len(need)), dtype=np.bool_)
    lens = np.fromiter((len(d.terms) for d in corp.docs), np.int64, M)
    flat = np.fromiter(itertools.chain.from_iterable(d.terms for d in corp.docs),
                       np.int64, int(lens.sum()))
    doc_ids = np.repeat(np.arange(M), lens)
    need_arr = np.asarray(need, np.int64)
    pos = np.searchsorted(need_arr, flat)
    pos_c = np.minimum(pos, len(need_arr) - 1)
    valid = need_arr[pos_c] == flat
    inc[doc_ids[valid], pos_c[valid]] = True
    D = inc.sum(axis=0).astype(np.float64)                 # D(w)
    CO = (inc.T.astype(np.float64) @ inc)                  # D(w_i, w_j)

    scores = np.zeros(K)
    for k in range(K):
        ids = [col[int(w)] for w in top[k]]
        s = 0.0
        for i in range(1, len(ids)):
            for j in range(i):
                denom = max(D[ids[j]], 1.0)
                s += np.log((CO[ids[i], ids[j]] + 1.0) / denom)
        scores[k] = s
    return scores


# ───────────── leave-one-reader-out recommender protocol ─────────────
# The reference demonstrates this evaluation by hand in its README
# (README.md:512-560) and scores it in R (plots.R:20-31): hide one
# reader per document before training, then ask where the trained
# model ranks the hidden reader among the document's non-readers.

def holdout_readers(corp: Corpus, seed: int = 0, min_readers: int = 2,
                    inplace: bool = False):
    """Remove one random reader (and its rating) from every document with
    at least ``min_readers`` readers; returns ``(corp_out, held)`` where
    ``held`` is the held-out ``[(doc, user)]`` pairs (1-based ids).
    Train on ``corp_out``, then score with :func:`heldout_reader_rank` /
    :func:`recall_at_k`.

    By default the caller's corpus is left untouched and ``corp_out`` is
    a deep copy with the holdouts removed; ``inplace=True`` edits ``corp``
    itself (then ``corp_out is corp``).
    """
    if not inplace:
        corp = corp.deepcopy()
    rng = np.random.default_rng(seed)
    held = []
    for d, doc in enumerate(corp.docs, start=1):
        if len(doc.readers) >= min_readers:
            # only readers listed ONCE are valid holdouts: popping one
            # copy of a duplicated reader would leave the user a reader,
            # so they'd never appear in the ranked non-reader list
            cnt = {}
            for u in doc.readers:
                cnt[u] = cnt.get(u, 0) + 1
            singles = [i for i, u in enumerate(doc.readers) if cnt[u] == 1]
            if not singles:
                continue
            i = singles[int(rng.integers(len(singles)))]
            held.append((d, doc.readers.pop(i)))
            doc.ratings.pop(i)  # ratings are parallel to readers
    return corp, held


def _ranked_users(model, d: int) -> list:
    """Ranked non-reader users for 1-based doc ``d`` (1-based ids).

    ``api.CTPF`` exposes this as its lazy ``drecs`` row; a
    ``StreamingCTPF`` exposes per-document ``scores`` and the packed
    reader arrays, ranked here in the same stable order."""
    if hasattr(model, "drecs"):
        return model.drecs[d - 1]
    p = model.packed
    row = np.asarray(model.scores(slice(d - 1, d))[0])
    order = np.argsort(-row, kind="stable")
    mask = np.ones(row.shape[0], dtype=bool)
    r = int(p.R[d - 1])
    if r:
        mask[p.readers[d - 1, :r]] = False
    return (order[mask[order]] + 1).tolist()


def ranked_users(model, held) -> dict:
    """Ranked non-reader lists for every distinct doc in ``held`` (the
    model's lazy ``drecs`` rows, or a ``StreamingCTPF``'s scores), each
    computed exactly once: share the result between
    :func:`heldout_reader_rank` and :func:`recall_at_k` instead of
    re-ranking per metric call."""
    return {d: _ranked_users(model, d) for d in dict.fromkeys(d for d, _ in held)}


def heldout_reader_rank(model, held, recs: Optional[dict] = None) -> np.ndarray:
    """Normalized rank in [0, 1] of each held-out reader among the
    document's ranked non-readers (0 = top recommendation; 0.5 ≈
    random).  ``model`` is a trained CTPF; ``held`` comes from
    :func:`holdout_readers`; pass ``recs=ranked_users(model, held)`` to
    reuse rankings across metrics."""
    if recs is None:
        recs = ranked_users(model, held)
    ranks = []
    for d, u in held:
        row = recs[d]
        ranks.append(row.index(u) / max(len(row) - 1, 1))
    return np.asarray(ranks)


def recall_at_k(model, held, k: int = 20, recs: Optional[dict] = None) -> float:
    """Fraction of held-out readers appearing in the top-``k``
    recommendations for their document."""
    if k <= 0:
        raise ValueError("k must be a positive integer.")
    if recs is None:
        recs = ranked_users(model, held)
    hits = 0
    for d, u in held:
        if u in recs[d][:k]:
            hits += 1
    return hits / max(len(held), 1)
