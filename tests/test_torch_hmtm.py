"""The port's hidden Markov topic model against the JAX package's, on CPU.

Both packages take the same numpy inputs, and the port's model starts
from the JAX init, injected through ``convert.py``.  In f64 the plain
E-step chunk and forward normaliser agree with JAX ``_estep_chunk`` and
``_forward`` to 1e-10, a full step and the bound to 1e-8 per iteration
(the JAX package's oracle tolerance, tests/test_hmtm.py), and so do
``predict`` and ``perplexity``; same-seed ``gendoc``/``gencorp`` draw the
same documents, and checkpoints cross between the packages both ways.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import topicmodelsvb_jl_tpu as tm
from topicmodelsvb_jl_tpu.datasets import synth_packed_nsf_scale as jax_synth
from topicmodelsvb_jl_tpu.models import hmtm as jax_hmtm
from topicmodelsvb_jl_tpu.ops.packing import bucketize_packed as jax_bucketize
from topicmodelsvb_jl_tpu.ops.packing import unit_counts as jax_unit_counts
from topicmodelsvb_jl_tpu.ops.segment import count_scatter as jax_count_scatter
from topicmodelsvb_jl_tpu.parallel.mesh import make_mesh
from topicmodelsvb_jl_tpu.utils.config import RuntimeConfig as JaxRuntimeConfig
import topicmodelsvb_jl_torch as tt
from topicmodelsvb_jl_torch import convert
from topicmodelsvb_jl_torch.kernels.hmtm_estep import hmtm_estep_ref, hmtm_logz_ref
from topicmodelsvb_jl_torch.models import hmtm as torch_hmtm
from topicmodelsvb_jl_torch.ops.packing import unit_counts

K, CHUNK = 4, 8
CORPUS = dict(M=30, V=40, K=3, seed=11, mean_tokens=25, mean_terms=12)
PACKED = dict(M=77, V=60, mean_terms=14, seed=2, chunk_docs=CHUNK)


def _ordered(pkg, **kw):
    """``tests/conftest.py``'s ``ordered_corpus``: a synthetic corpus
    expanded to one entry a token."""
    corp = pkg.synth_corpus(**{**CORPUS, **kw})
    pkg.expand_corp(corp)
    return corp


def _inputs(kind):
    """(JAX input, port input): the expanded Corpus, or a packed corpus
    with unit counts (the chip's NSF path, as bench_hmtm.py builds it)."""
    if kind == "corpus":
        return _ordered(tm), _ordered(tt)
    return (jax_unit_counts(jax_synth(**PACKED)),
            unit_counts(tt.synth_packed_nsf_scale(**PACKED)))


def _models(kind="corpus", seed=3, K=K):
    jin, tin = _inputs(kind)
    jm = tm.HMTM(jin, K, runtime=JaxRuntimeConfig(chunk_docs=CHUNK, dtype="float64",
                                                  pad_multiple=8),
                 mesh=make_mesh(n_devices=1), seed=seed)
    pm = tt.HMTM(tin, K, tt.RuntimeConfig(chunk_docs=CHUNK, dtype="float64", pad_multiple=8),
                 device="cpu", seed=seed)
    pm.state = convert.hmtm_state_from_numpy(jm.state._asdict(), "cpu", torch.float64)
    return jm, pm


def _close(got, want, rtol, what, atol=1e-13):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=what)


def _chunk(seed, B=7, L=12, V=20):
    """One chunk: a full document, trailing padding, an empty document, a
    one-token document, a document whose first slots are padding (interior
    padding), and a document with tokens but doc_mask 0."""
    r = np.random.default_rng(seed)
    n = np.array([L, 7, 0, 1, L, 9, 5][:B])
    tm_ = (np.arange(L)[None, :] < n[:, None]).astype(np.float64)
    tm_[4, :3] = 0.0
    tm_[4, 6] = 0.0
    terms = r.integers(0, V, size=(B, L)).astype(np.int32) * (tm_ > 0)
    doc_mask = np.ones(B)
    doc_mask[5] = 0.0
    betaT = r.dirichlet(np.ones(V), size=K).T + jax_hmtm.EPSILON
    return dict(betaT_eps=betaT, terms=terms, tmask=tm_, doc_mask=doc_mask,
                eta=r.uniform(0.5, 2.0, K), alpha=r.uniform(0.5, 2.0, (K, K)),
                tau=r.uniform(0.5, 3.0, (B, K)), gamma=r.uniform(0.5, 3.0, (B, K, K)))


@pytest.mark.parametrize("viter", [0, 1, 10])
def test_plain_estep_and_logz_match_jax_on_one_chunk(viter):
    x = _chunk(seed=viter)
    j = {k: jnp.asarray(v) for k, v in x.items()}
    t = {k: torch.as_tensor(v) for k, v in x.items()}
    vtol = 1e-3
    jt, jg, jbt, _, _ = jax_hmtm._estep_chunk(
        j["betaT_eps"], j["eta"], j["alpha"], j["terms"], j["tmask"], j["doc_mask"], j["tau"],
        j["gamma"], viter, vtol, x["betaT_eps"].shape[0])
    tt_, tg, r = hmtm_estep_ref(t["betaT_eps"], t["terms"], t["tmask"], t["doc_mask"], t["eta"],
                                t["alpha"], t["tau"], t["gamma"], viter=viter, vtol=vtol)
    _close(tt_, jt, 1e-10, "tau")
    _close(tg, jg, 1e-10, "gamma")
    # r against the JAX package's final forward-backward, and its scatter
    p0, A = jax_hmtm._tilde(jnp.asarray(tt_.numpy()), jnp.asarray(tg.numpy()))
    Bv = j["betaT_eps"][j["terms"]]
    a, c, logz = jax_hmtm._forward(p0, A, Bv, j["tmask"])
    _, _, jr = jax_hmtm._backward_stats(a, c, A, Bv, j["tmask"], with_r=True)
    _close(r, jr, 1e-10, "r")
    _close(jax_count_scatter(jnp.asarray(r.numpy()).reshape(-1, K), j["terms"].reshape(-1),
                             x["betaT_eps"].shape[0]), jbt, 1e-10, "beta_temp")
    assert torch.all(r[torch.as_tensor(x["tmask"]) == 0] == 0)
    assert torch.equal(tt_[5], t["tau"][5]) and torch.equal(tg[5], t["gamma"][5])
    if viter == 0:
        assert torch.equal(tt_, t["tau"]) and torch.equal(tg, t["gamma"])
    got = hmtm_logz_ref(t["betaT_eps"], t["terms"], t["tmask"], tt_, tg)
    _close(got, logz, 1e-10, "logZ")
    assert float(got[2]) == 0.0   # the empty document: no real slot


def test_unit_counts_byte_identical():
    for chunk in (None, CHUNK):
        a, b = jax_synth(**PACKED), tt.synth_packed_nsf_scale(**PACKED)
        if chunk:
            a, b = jax_bucketize(a, chunk=chunk, pad_multiple=8), tt.bucketize_packed(
                b, chunk=chunk, pad_multiple=8)
        a, b = jax_unit_counts(a), unit_counts(b)
        assert a.max_count == b.max_count == 1
        for f in ("terms", "counts", "C", "N", "doc_mask"):
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), f
        for sa, sb in zip(a.segments or (), b.segments or ()):
            assert sa.counts.tobytes() == sb.counts.tobytes()
        assert (a.segments is None) == (b.segments is None) == (chunk is None)


@pytest.mark.parametrize("kind", ["corpus", "packed"])
def test_step_and_elbo_match_jax_every_iteration(kind):
    """make_step/make_elbo against the JAX package's, state by state, on a
    bucketed corpus of several segments and chunks."""
    jm, pm = _models(kind)
    p = jm.packed
    assert len(p.segments) >= 2 and p.M_pad // CHUNK >= 2
    kw = dict(viter=10, vtol=1.0 / K**2, niter=1000, ntol=1.0 / K**2, chunk_docs=CHUNK)
    jstep = jax.jit(jax_hmtm.make_step(p, K, **kw))
    jelbo = jax.jit(jax_hmtm.make_elbo(p, K, chunk_docs=CHUNK))
    tstep = torch_hmtm.make_step(pm.packed, K, device="cpu", **kw)
    telbo = torch_hmtm.make_elbo(pm.packed, K, chunk_docs=CHUNK)
    jdata = tuple(tuple(jnp.asarray(getattr(s, f)) for s in p.segments)
                  for f in ("terms", "counts", "doc_mask"))
    tdata = pm._data_arrays()
    js, ts = jm.state, pm.state
    for it in range(1, 6):
        js = jstep(js, *jdata, jnp.asarray(float(p.M)))
        ts = tstep(ts, *tdata, float(pm.M))
        got = convert.hmtm_state_to_numpy(ts)
        for f in ("eta", "alpha", "beta", "tau", "gamma"):
            _close(got[f], getattr(js, f), 1e-8, f"{f} at iteration {it}", atol=1e-12)
        je, te = float(jnp.sum(jelbo(js, *jdata))), float(torch.sum(telbo(ts, *tdata)))
        assert abs(te - je) <= 1e-8 * abs(je), (it, te, je)


@pytest.fixture(scope="module")
def trained():
    """The JAX model and the port's from one init, each trained 5
    iterations with the bound checked every iteration; the tests that
    take it leave both as they are."""
    jm, pm = _models()
    jm.train(iter=5, checkelbo=1, printelbo=False)
    pm.train(iter=5, checkelbo=1, printelbo=False)
    return jm, pm


def test_train_matches_jax_and_the_elbo_rises(trained):
    jm, pm = trained
    _close([r.elbo for r in pm.trainer.trace], [r.elbo for r in jm.trainer.trace], 1e-8, "elbo")
    for f in ("eta", "alpha", "beta", "tau", "gamma"):
        _close(getattr(pm, f), getattr(jm, f), 1e-8, f, atol=1e-12)
    m = tt.HMTM(_ordered(tt), 5, tt.RuntimeConfig(chunk_docs=CHUNK, dtype="float64",
                                                   pad_multiple=8), device="cpu", seed=3)
    m.train(iter=15, checkelbo=1, printelbo=False)
    deltas = [r.delta_elbo for r in m.trainer.trace if r.delta_elbo is not None]
    assert len(deltas) >= 10 and all(d > -1e-6 for d in deltas[1:])   # tests/test_hmtm.py


def test_surface_matches_jax(trained):
    jm, pm = trained
    assert repr(pm) == repr(jm) == f"Hidden Markov topic model with {K} topics."
    docs = list(range(1, pm.M + 1))
    _close(pm.topicdist(docs), jm.topicdist(docs), 1e-8, "topicdist")
    _close(pm.transdist(docs), jm.transdist(docs), 1e-8, "transdist")
    assert pm.transdist(2).shape == (K, K)
    np.testing.assert_allclose(pm.transdist(2).sum(axis=0), 1.0, rtol=1e-12)
    for bad in (0, pm.M + 1, [1, pm.M + 1]):
        for m in (jm, pm):
            with pytest.raises(Exception) as e:
                m.transdist(bad)
            assert type(e.value).__name__ == "CorpusError"
            with pytest.raises(Exception) as e:
                m.topicdist(bad)
            assert type(e.value).__name__ == "CorpusError"
    np.testing.assert_array_equal(pm.topics, jm.topics)


def test_condensed_corpus_is_refused():
    corp = tt.synth_corpus(M=16, V=20, K=2, seed=0)
    tt.condense_corp(corp)
    assert any(c > 1 for doc in corp.docs for c in doc.counts)
    with pytest.raises(ValueError, match="order-preserving"):
        tt.HMTM(corp, 2, device="cpu")
    with pytest.raises(ValueError, match="order-preserving"):
        tt.HMTM(tt.pack_corpus(corp, pad_multiple=8), 2, device="cpu")


def test_predict_and_perplexity_match_jax(trained):
    jm, pm = trained
    jtest, ttest = _ordered(tm, M=11, seed=12), _ordered(tt, M=11, seed=12)
    jp, tp = tm.predict(jtest, jm, iter=5), tt.predict(ttest, pm, iter=5)
    assert isinstance(tp, tt.HMTM) and tp.M == 11
    for f in ("tau", "gamma"):
        _close(getattr(tp, f), getattr(jp, f), 1e-8, f"predict {f}", atol=1e-12)
    for f in ("eta", "alpha", "beta"):   # the globals: the trained ones, bit for bit
        assert torch.equal(getattr(tp.state, f), getattr(pm.state, f)), f
    a, b = tm.perplexity(jtest, jm), tt.perplexity(ttest, pm)
    assert np.isfinite(b) and abs(a - b) <= 1e-8 * a


def test_gendoc_and_gencorp_draw_as_jax(trained):
    jm, pm = trained
    a = tm.gencorp(jm, 6, laplace_smooth=1e-3, seed=4)
    b = tt.gencorp(pm, 6, laplace_smooth=1e-3, seed=4)
    assert [(d.terms, d.counts) for d in a.docs] == [(d.terms, d.counts) for d in b.docs]
    assert a.vocab == b.vocab and sum(len(d) for d in b.docs) > 0
    assert all(c == 1 for d in b.docs for c in d.counts)   # ordered tokens
    d1 = tm.gendoc(jm, rng=np.random.default_rng(2))
    d2 = tt.gendoc(pm, rng=np.random.default_rng(2))
    assert (d1.terms, d1.counts) == (d2.terms, d2.counts) and len(d2.terms) > 0


@pytest.mark.parametrize("field", ["eta", "alpha", "beta", "tau", "gamma"])
def test_check_model_catches_a_corrupted_state(field):
    jm, pm = _models()
    for m, replace in ((jm, lambda s, v: s._replace(**{field: v})),
                       (pm, lambda s, v: dataclasses.replace(s, **{field: torch.as_tensor(v)}))):
        bad = np.array(getattr(m.state, field))
        bad.reshape(-1)[0] = -1.0
        m.state = replace(m.state, bad)
        with pytest.raises(Exception) as e:
            m.train(iter=1, printelbo=False)
        assert type(e.value).__name__ == "TopicModelError"
    with pytest.raises(tt.TopicModelError, match=field):
        tt.check_model(pm)


def test_checkpoints_cross_between_packages_and_resume(trained, tmp_path):
    jm = trained[0]
    jpath = str(tmp_path / "jax.npz")
    tm.save_checkpoint(jpath, jm)
    corp = _ordered(tt)
    pm = tt.load_checkpoint(jpath, corp, device="cpu")
    assert isinstance(pm, tt.HMTM) and pm.trained_iters == 5
    fields = ("eta", "alpha", "beta", "tau", "gamma")
    for f in fields + ("elbo",):
        np.testing.assert_array_equal(np.asarray(getattr(pm, f)), np.asarray(getattr(jm, f)), f)
    ppath = str(tmp_path / "port.npz")
    tt.save_checkpoint(ppath, pm)
    jm2 = tm.load_checkpoint(ppath, _ordered(tm))
    for f in fields:
        np.testing.assert_array_equal(getattr(jm2, f), getattr(jm, f), f)
    jm2.train(iter=1, checkelbo=1, printelbo=False)
    pm.train(iter=1, checkelbo=1, printelbo=False)
    assert pm.trainer.trace[0].k == jm2.trainer.trace[0].k == 6
    assert abs(pm.elbo - jm2.elbo) <= 1e-8 * abs(jm2.elbo)
    for f in fields:
        _close(getattr(pm, f), getattr(jm2, f), 1e-8, f, atol=1e-12)

    # a resume continues the straight run's trace (tests/test_hmtm.py)
    rt = tt.RuntimeConfig(chunk_docs=CHUNK, dtype="float64", pad_multiple=8)
    m = tt.HMTM(corp, K, rt, device="cpu", seed=5)
    m.train(iter=3, checkelbo=1, printelbo=False)
    path = str(tmp_path / "resume.npz")
    tt.save_checkpoint(path, m)
    resumed = tt.load_checkpoint(path, corp, device="cpu")
    resumed.train(iter=2, checkelbo=1, printelbo=False)
    assert [r.k for r in resumed.trainer.trace] == [4, 5]
    straight = tt.HMTM(corp, K, rt, device="cpu", seed=5)
    straight.train(iter=5, checkelbo=1, printelbo=False)
    _close([r.elbo for r in resumed.trainer.trace],
           [r.elbo for r in straight.trainer.trace[3:]], 1e-10, "resumed elbo")
    for f in fields:
        _close(getattr(resumed, f), getattr(straight, f), 1e-10, f, atol=1e-14)
