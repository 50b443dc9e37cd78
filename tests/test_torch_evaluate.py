"""The port's ``evaluate.py`` against the JAX package, on CPU.

Each metric runs in both packages from one state: the JAX model's,
trained in f64 from a Corpus made with numpy from a seed and copied into
the port's model through ``convert.py``.  Perplexity agrees to 1e-8
relative (its posterior comes from ``predict``'s fixpoint, whose f64
parity is 1e-8); the host-side results (coherence, the held-out readers,
ranks and recall) are equal.
"""

import numpy as np
import pytest
import torch

import topicmodelsvb_jl_tpu as tm
from topicmodelsvb_jl_tpu.parallel.mesh import make_mesh
from topicmodelsvb_jl_tpu.utils.config import RuntimeConfig as JaxRuntimeConfig
import topicmodelsvb_jl_torch as tt
from topicmodelsvb_jl_torch import convert

CORPUS = dict(M=90, V=45, K=3, U=24, seed=8, mean_tokens=22, mean_terms=11, mean_readers=4)
N_TRAIN, K, CHUNK = 70, 3, 16
FROM_NUMPY = {"LDA": convert.lda_state_from_numpy, "fLDA": convert.flda_state_from_numpy,
              "CTM": convert.ctm_state_from_numpy, "fCTM": convert.fctm_state_from_numpy,
              "CTPF": convert.ctpf_state_from_numpy}


def _split(pkg):
    """(train, test) over one vocabulary; the test documents keep only
    the terms some training document holds (a term no training document
    holds has beta = 0, and CTM's log beta is then -inf in both
    packages)."""
    c = pkg.synth_corpus(**CORPUS)
    seen = {t for d in c.docs[:N_TRAIN] for t in d.terms}
    test = []
    for d in c.docs[N_TRAIN:]:
        keep = [i for i, t in enumerate(d.terms) if t in seen]
        test.append(pkg.Document(terms=[d.terms[i] for i in keep],
                                 counts=[d.counts[i] for i in keep],
                                 readers=d.readers, ratings=d.ratings))
    return tuple(pkg.Corpus(docs=docs, vocab=dict(c.vocab), users=dict(c.users))
                 for docs in (c.docs[:N_TRAIN], test))


def _pair(fam, jcorp, tcorp, iters=2):
    """The JAX model trained ``iters`` iterations and the port's model
    holding its state exactly."""
    jm = getattr(tm, fam)(jcorp, K, runtime=JaxRuntimeConfig(chunk_docs=CHUNK, dtype="float64"),
                          mesh=make_mesh(n_devices=1), seed=2)
    jm.train(iter=iters, checkelbo=float("inf"), printelbo=False)
    pm = getattr(tt, fam)(tcorp, K, tt.RuntimeConfig(chunk_docs=CHUNK, dtype="float64"),
                          device="cpu", seed=2)
    pm.state = FROM_NUMPY[fam](jm.state._asdict(), "cpu", torch.float64)
    pm._finalize()
    return jm, pm


@pytest.fixture(scope="module")
def corpora():
    return dict(jax=_split(tm), torch=_split(tt))


@pytest.mark.parametrize("fam", ["LDA", "fLDA", "CTM", "fCTM"])
def test_perplexity_matches_jax(fam, corpora):
    jm, pm = _pair(fam, corpora["jax"][0], corpora["torch"][0])
    a = tm.perplexity(corpora["jax"][1], jm, iter=5)
    b = tt.perplexity(corpora["torch"][1], pm, iter=5)
    assert np.isfinite(b) and 1.0 < b < CORPUS["V"]
    assert b == pytest.approx(a, rel=1e-8)
    # chunked scoring sums the same tokens as one chunk
    assert tt.perplexity(corpora["torch"][1], pm, iter=5, chunk=7) == pytest.approx(b, rel=1e-12)
    if fam == "LDA":
        np.testing.assert_array_equal(tt.topic_coherence(pm, N=6), tm.topic_coherence(jm, N=6))
        np.testing.assert_array_equal(tt.topic_coherence(pm, N=4, corp=corpora["torch"][1]),
                                      tm.topic_coherence(jm, N=4, corp=corpora["jax"][1]))
        with pytest.raises(ValueError, match="at least 2"):
            tt.topic_coherence(pm, N=1)


def test_perplexity_and_coherence_reject_what_jax_rejects(corpora):
    pc = tt.CTPF(corpora["torch"][0], K, tt.RuntimeConfig(chunk_docs=CHUNK), device="cpu")
    with pytest.raises(TypeError, match="not defined for CTPF"):
        tt.perplexity(corpora["torch"][1], pc)
    p = tt.synth_packed_nsf_scale(M=40, V=30, mean_terms=8, seed=1, chunk_docs=8)
    packed_lda = tt.LDA(p, 2, tt.RuntimeConfig(chunk_docs=8), device="cpu")
    with pytest.raises(ValueError, match="pass corp="):
        tt.topic_coherence(packed_lda)
    with pytest.raises(ValueError, match="train the model first"):
        tt.topic_coherence(tt.LDA(corpora["torch"][0], K, device="cpu"))


@pytest.mark.parametrize("inplace", [False, True])
def test_holdout_readers_matches_jax(inplace, corpora):
    ja, ta = (tm.Corpus(docs=[d.copy() for d in c[0].docs], vocab=dict(c[0].vocab),
                        users=dict(c[0].users)) for c in (corpora["jax"], corpora["torch"]))
    jc, jheld = tm.holdout_readers(ja, seed=7, inplace=inplace)
    tc, theld = tt.holdout_readers(ta, seed=7, inplace=inplace)
    assert theld == jheld and len(theld) > 0
    assert (tc is ta) == inplace
    for x, y in zip(jc.docs, tc.docs):
        assert (x.terms, x.counts, x.readers, x.ratings) == (y.terms, y.counts, y.readers,
                                                             y.ratings)
    assert jc.users == tc.users


def test_heldout_rank_and_recall_match_jax(corpora):
    """From one CTPF state.  The corpus has no tied scores on a held-out
    document's row (checked below), so the rankings are the same in both
    packages, not merely the same up to the order of ties."""
    jcorp, jheld = tm.holdout_readers(corpora["jax"][0], seed=3)
    tcorp, theld = tt.holdout_readers(corpora["torch"][0], seed=3)
    assert theld == jheld
    jc, pc = _pair("CTPF", jcorp, tcorp, iters=3)
    scores = np.asarray(jc.scores)
    for d, _ in jheld:
        s = np.sort(scores[d - 1])
        assert np.all(np.diff(s) > 1e-9 * np.abs(s).max()), f"tied scores in document {d}"
    np.testing.assert_allclose(pc.scores, scores, rtol=1e-10)
    recs = tt.ranked_users(pc, theld)
    assert recs == tm.ranked_users(jc, jheld)
    ranks = tt.heldout_reader_rank(pc, theld, recs=recs)
    np.testing.assert_array_equal(ranks, tm.heldout_reader_rank(jc, jheld))
    np.testing.assert_array_equal(tt.heldout_reader_rank(pc, theld), ranks)
    assert np.all((ranks >= 0) & (ranks <= 1))
    for k in (1, 5, 20):
        assert tt.recall_at_k(pc, theld, k=k) == tm.recall_at_k(jc, jheld, k=k)
    with pytest.raises(ValueError, match="positive"):
        tt.recall_at_k(pc, theld, k=0)
