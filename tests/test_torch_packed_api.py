"""Models built from a ``PackedCorpus`` on the port, on CPU: the five tests
of the JAX package's ``tests/test_packed_api.py``.

The checkpoint round trip keys on the packed object the user holds, before
bucketing, and the port also loads the JAX package's checkpoint of the
same model and resumes it as the JAX package does (1e-8 relative, the
port's parity tolerance).  The JAX test's 4-device mesh becomes a 2-shard
bucketing, which a model with no mesh (one shard) refuses.
"""

import numpy as np
import pytest

import topicmodelsvb_jl_tpu as tm
from topicmodelsvb_jl_tpu.parallel.mesh import make_mesh
from topicmodelsvb_jl_tpu.utils.config import RuntimeConfig as JaxRuntimeConfig
import topicmodelsvb_jl_torch as tt
from topicmodelsvb_jl_torch.api import TopicModelError


def _rt(**kw):
    return tt.RuntimeConfig(chunk_docs=8, dtype="float64", pad_multiple=8, **kw)


def test_packed_checkpoint_roundtrip(tmp_path):
    """A PackedCorpus-built model's checkpoint loads from the same packed
    object (its fingerprint is the pre-bucketing one) and resumes on the
    same path; the JAX package's checkpoint of the same model loads too
    and resumes as the JAX package does."""
    kw = dict(M=40, V=60, mean_terms=12, seed=3, chunk_docs=8)
    packed = tt.synth_packed_nsf_scale(**kw)
    m = tt.LDA(packed, 3, _rt(), device="cpu", seed=2)
    m.train(iter=3, checkelbo=1, printelbo=False)
    path = str(tmp_path / "m.ckpt")
    tt.save_checkpoint(path, m)
    m2 = tt.load_checkpoint(path, packed, device="cpu")
    np.testing.assert_allclose(m2.beta, m.beta, rtol=1e-12)
    m.train(iter=2, checkelbo=1, printelbo=False)
    m2.train(iter=2, checkelbo=1, printelbo=False)
    np.testing.assert_allclose(m2.beta, m.beta, rtol=1e-10)

    jm = tm.LDA(tm.datasets.synth_packed_nsf_scale(**kw), 3,
                runtime=JaxRuntimeConfig(chunk_docs=8, dtype="float64", pad_multiple=8),
                mesh=make_mesh(n_devices=1), seed=2)
    jm.train(iter=3, checkelbo=1, printelbo=False)
    jpath = str(tmp_path / "jax.ckpt")
    tm.checkpoint.save(jpath, jm)
    pm = tt.load_checkpoint(jpath, packed, device="cpu")
    np.testing.assert_array_equal(pm.beta, np.asarray(jm.beta))
    np.testing.assert_array_equal(pm.alpha, np.asarray(jm.alpha))
    jm.train(iter=2, checkelbo=1, printelbo=False)
    pm.train(iter=2, checkelbo=1, printelbo=False)
    np.testing.assert_allclose([r.elbo for r in pm.trainer.trace],
                               [r.elbo for r in jm.trainer.trace], rtol=1e-8)
    np.testing.assert_allclose(pm.beta, np.asarray(jm.beta), rtol=1e-8, atol=1e-14)
    np.testing.assert_allclose(pm.gamma, np.asarray(jm.gamma), rtol=1e-8)


def test_prebucketized_packed_input_preserves_doc_stats():
    """N and C come back in document order when the packed input was
    already bucketed (rows sorted by length, padding rows between)."""
    packed = tt.synth_packed_nsf_scale(M=33, V=50, mean_terms=10, seed=5, chunk_docs=8)
    true_N = packed.N[:33].tolist()
    true_C = packed.C[:33].tolist()
    b = tt.bucketize_packed(packed, chunk=8, n_shards=1)
    assert b.order is not None and not np.array_equal(b.order[:33], np.arange(33))
    m = tt.LDA(b, 3, _rt(), device="cpu", seed=1)
    assert m.N == true_N
    assert m.C == true_C
    assert sum(m.C) == sum(true_C)


def test_packed_guards():
    packed = tt.synth_packed_nsf_scale(M=16, V=40, mean_terms=8, seed=1, chunk_docs=8)
    # CTPF needs the reader arrays
    with pytest.raises(ValueError, match="reader arrays"):
        tt.CTPF(packed, 3, _rt(), device="cpu")
    # DTM needs stamps: a clear error, not an AttributeError
    with pytest.raises(TopicModelError, match="stamps"):
        tt.DTM(packed, 3, delta=1.0, runtime=_rt(), device="cpu")
    # the corpus-text surfaces raise clearly
    m = tt.LDA(packed, 3, _rt(), device="cpu")
    with pytest.raises(TopicModelError, match="PackedCorpus"):
        m.showdocs(1)
    with pytest.raises(TopicModelError, match="PackedCorpus"):
        m.getusers()
    # showtopics works with placeholder names; gencorp makes up a vocabulary
    m.train(iter=2, checkelbo=np.inf, printelbo=False)
    m.showtopics(V=3, cols=2)
    corp = tt.gencorp(m, M=4, seed=0)
    assert len(corp) == 4 and len(corp.vocab) == m.V


def test_prebucketized_shard_mismatch_rejected():
    """A corpus bucketed for 2 shards is refused by a model of one shard
    (no mesh): its shard-major rows would pair with the wrong per-document
    state."""
    packed = tt.synth_packed_nsf_scale(M=33, V=50, mean_terms=10, seed=5, chunk_docs=8)
    b = tt.bucketize_packed(packed, chunk=8, n_shards=2)
    with pytest.raises(TopicModelError, match="n_shards"):
        tt.LDA(b, 3, _rt(), device="cpu", seed=1)


def test_dtm_basemodel_from_packed_corpus_checks_M():
    """A basemodel built from a PackedCorpus (no Corpus) meets the clear
    document-count TopicModelError, not an AttributeError."""
    packed = tt.synth_packed_nsf_scale(M=16, V=20, mean_terms=6, seed=1, chunk_docs=8)
    base = tt.LDA(packed, 2, _rt(), device="cpu", seed=0)
    corp = tt.synth_corpus(M=20, V=20, K=2, seed=0, n_slices=2)
    with pytest.raises(TopicModelError, match="matching number"):
        tt.DTM(corp, 2, delta=1.0, basemodel=base, runtime=_rt(), device="cpu")
