"""The port's Corpus-built models and post-hoc surface against the JAX
package, on CPU.

Both packages build each family from the same ``Corpus`` (made with numpy
from a seed); the packed arrays must be equal, and two training steps in
f64 from the JAX init (injected through ``convert.py``) agree to 1e-8
relative per field, the tolerance of the per-family parity tests.  The
post-hoc checks start both packages from one state, the JAX model's,
copied into the port's: displays print the same text, ``gencorp`` draws
the same documents, ``predict`` fits the same per-document state (1e-8)
and leaves every global bit for bit as it was.
"""

import numpy as np
import pytest
import torch

import topicmodelsvb_jl_tpu as tm
from topicmodelsvb_jl_tpu.parallel.mesh import make_mesh
from topicmodelsvb_jl_tpu.utils.config import RuntimeConfig as JaxRuntimeConfig
import topicmodelsvb_jl_torch as tt
from topicmodelsvb_jl_torch import convert

CORPUS = dict(M=80, V=40, K=3, U=15, seed=5, mean_tokens=20, mean_terms=10, mean_readers=3)
N_TRAIN, K, CHUNK = 60, 3, 16
FAMILIES = ("LDA", "fLDA", "CTM", "fCTM", "CTPF")
FROM_NUMPY = {"LDA": convert.lda_state_from_numpy, "fLDA": convert.flda_state_from_numpy,
              "CTM": convert.ctm_state_from_numpy, "fCTM": convert.fctm_state_from_numpy,
              "CTPF": convert.ctpf_state_from_numpy}
TO_NUMPY = convert.lda_state_to_numpy   # every family's: its dataclass fields
PACKED = ("terms", "counts", "doc_mask", "N", "C", "order", "inv_order", "readers",
          "ratings", "R")


def _split(pkg):
    """(train, test): the first N_TRAIN documents and the rest, one
    vocabulary and one user list; every third document has a title.  The
    test documents keep only the terms some training document holds (a
    term no training document holds has beta = 0, and CTM's log beta is
    then -inf in both packages)."""
    c = pkg.synth_corpus(**CORPUS)
    for d, doc in enumerate(c.docs, start=1):
        if d % 3 == 0:
            doc.title = f"paper {d}"
    seen = {t for d in c.docs[:N_TRAIN] for t in d.terms}
    test = []
    for d in c.docs[N_TRAIN:]:
        keep = [i for i, t in enumerate(d.terms) if t in seen]
        test.append(pkg.Document(terms=[d.terms[i] for i in keep],
                                 counts=[d.counts[i] for i in keep]))
    return tuple(pkg.Corpus(docs=docs, vocab=dict(c.vocab), users=dict(c.users))
                 for docs in (c.docs[:N_TRAIN], test))


def _jax_model(fam, corp):
    return getattr(tm, fam)(corp, K, runtime=JaxRuntimeConfig(chunk_docs=CHUNK, dtype="float64"),
                            mesh=make_mesh(n_devices=1), seed=3)


def _port_model(fam, corp, jax_state=None):
    m = getattr(tt, fam)(corp, K, tt.RuntimeConfig(chunk_docs=CHUNK, dtype="float64"),
                         device="cpu", seed=3)
    if jax_state is not None:
        m.state = FROM_NUMPY[fam](jax_state._asdict(), "cpu", torch.float64)
    return m


@pytest.fixture(scope="module")
def corpora():
    return dict(jax=_split(tm), torch=_split(tt))


@pytest.fixture(scope="module")
def trained(corpora):
    """Per family: the JAX model and the port's, each built from the
    training Corpus, the port's started from the JAX init, both trained
    2 iterations."""
    out = {}
    for fam in FAMILIES:
        jm = _jax_model(fam, corpora["jax"][0])
        pm = _port_model(fam, corpora["torch"][0], jm.state)
        for m in (jm, pm):
            m.train(iter=2, checkelbo=1, printelbo=False)
        out[fam] = (jm, pm)
    return out


def _frozen(fam, trained, corpora):
    """The port's model of ``fam`` holding the trained JAX state exactly."""
    jm = trained[fam][0]
    pm = _port_model(fam, corpora["torch"][0], jm.state)
    pm._finalize()
    return jm, pm


def _outcome(fn):
    try:
        return "ok", fn()
    except Exception as e:   # compared across packages: both must fail alike
        return type(e).__name__, str(e)


@pytest.mark.parametrize("fam", FAMILIES)
def test_corpus_built_models_match_jax(fam, trained):
    jm, pm = trained[fam]
    assert pm.corp is not None and pm.device.type == "cpu"
    assert (pm.M, pm.V, pm.U, pm.N, pm.C, pm.chunk_docs) == \
        (jm.M, jm.V, jm.U, jm.N, jm.C, jm.chunk_docs)
    a, b = jm.packed, pm.packed
    for f in PACKED:
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            assert x.dtype == y.dtype and x.shape == y.shape and x.tobytes() == y.tobytes(), f
    assert len(a.segments) == len(b.segments) >= 2
    for sa, sb in zip(a.segments, b.segments):
        assert (sa.L, sa.n_local, sa.loc_start) == (sb.L, sb.n_local, sb.loc_start)
        for f in ("terms", "counts", "doc_mask"):
            assert getattr(sa, f).tobytes() == getattr(sb, f).tobytes(), f
    np.testing.assert_allclose([r.elbo for r in pm.trainer.trace],
                               [r.elbo for r in jm.trainer.trace], rtol=1e-8)
    got = TO_NUMPY(pm.state)
    for f, x in got.items():
        if f != "elbo":
            np.testing.assert_allclose(x, np.asarray(getattr(jm.state, f)), rtol=1e-8,
                                       atol=1e-12, err_msg=f)
    assert pm.getvocab() == jm.getvocab() and pm.getusers() == jm.getusers()


def test_displays_print_as_jax(trained, corpora, capsys):
    outs = []
    for fam in ("LDA", "CTPF"):
        jm, pm = _frozen(fam, trained, corpora)
        for m in (jm, pm):
            calls = [lambda: m.showtopics(), lambda: m.showtopics(V=4, cols=2),
                     lambda: m.showtopics(topics=2, V=50), lambda: m.showtopics(topics=[4]),
                     lambda: m.showtopics(V=0), lambda: m.showdocs([1, 3]),
                     lambda: m.showtitles([2, 3])]
            if fam == "CTPF":
                calls += [lambda: m.showlibs(), lambda: m.showlibs([2, 1]),
                          lambda: m.showlibs(CORPUS["U"] + 1), lambda: m.showdrecs([1, 3, 6], U=4),
                          lambda: m.showdrecs(2), lambda: m.showdrecs(U=0),
                          lambda: m.showurecs([1, 2], M=5), lambda: m.showurecs(M=3),
                          lambda: m.showurecs(0)]
            got = []
            for call in calls:
                res = _outcome(call)
                got.append((res, capsys.readouterr().out))
            outs.append(got)
    assert outs[0] == outs[1] and outs[2] == outs[3]
    assert outs[1][0][1].startswith("topic 1   ")
    assert outs[3][7][1].startswith(" ●●● User 1\n ●●● user1\n")


def test_displays_need_a_corpus():
    p = tt.synth_packed_nsf_scale(M=40, V=30, mean_terms=8, seed=1, chunk_docs=8)
    m = tt.LDA(p, 2, tt.RuntimeConfig(chunk_docs=8), device="cpu")
    for call in (m.showdocs, m.showtitles, m.getvocab, m.getusers):
        with pytest.raises(tt.TopicModelError, match="PackedCorpus"):
            call()


def test_warm_start_sets_alef_as_jax(trained, corpora):
    jl, pl = _frozen("LDA", trained, corpora)
    jc = _jax_model("CTPF", corpora["jax"][0]).warm_start_from(jl)
    tc = _port_model("CTPF", corpora["torch"][0]).warm_start_from(pl)
    np.testing.assert_array_equal(tc.alef, np.asarray(jc.state.alef))
    assert tc.state.alef_old is tc.state.alef and tc.alef.dtype == np.float64
    with pytest.raises(ValueError, match="share K and V"):
        _port_model("CTPF", corpora["torch"][0]).warm_start_from(
            tt.LDA(corpora["torch"][0], K + 1, device="cpu"))


def _per_doc_close(jp, tp, fam):
    fields = type(tp)._per_doc_fields
    assert fields == getattr(tm, fam)._per_doc_fields
    got = TO_NUMPY(tp.state)
    for f in fields:
        assert np.all(np.isfinite(got[f])), f
        np.testing.assert_allclose(got[f], np.asarray(getattr(jp.state, f)), rtol=1e-8,
                                   atol=1e-12, err_msg=f)


@pytest.mark.parametrize("fam", ["LDA", "fLDA", "CTM", "fCTM"])
def test_predict_matches_jax_and_keeps_the_globals(fam, trained, corpora):
    jm, pm = _frozen(fam, trained, corpora)
    before = {f: v.clone() for f, v in vars(pm.state).items()}
    jp = tm.predict(corpora["jax"][1], jm, iter=5)
    tp = tt.predict(corpora["torch"][1], pm, iter=5)
    assert type(tp) is type(pm) and tp.device == pm.device and tp.M == CORPUS["M"] - N_TRAIN
    _per_doc_close(jp, tp, fam)
    rows = np.arange(1, tp.M + 1)
    np.testing.assert_allclose(tp.topicdist(rows), jp.topicdist(rows), rtol=1e-8)
    for f, v in vars(pm.state).items():   # the trained model: untouched
        assert torch.equal(v, before[f]), f
    for f, v in vars(tp.state).items():   # every global: the trained one, bit for bit
        if f not in type(tp)._per_doc_fields and f != "elbo":
            assert torch.equal(v, before[f.removesuffix("_old")]), f
    assert tp.topics is pm.topics


def test_infer_on_two_same_shaped_corpora_matches_jax(trained, corpora):
    """Two held-out corpora with the same document lengths (so the same
    packed shapes) and different term ids: each matches JAX, whose step
    cache serves both from one compiled step."""
    jm, pm = _frozen("LDA", trained, corpora)
    perm = np.random.default_rng(9).permutation(CORPUS["V"]) + 1
    pairs = []
    for pkg in (tm, tt):
        a = _split(pkg)[1]
        b = pkg.Corpus(docs=[pkg.Document(terms=[int(perm[t - 1]) for t in d.terms],
                                          counts=d.counts) for d in a.docs],
                       vocab=dict(a.vocab), users=dict(a.users))
        pairs.append((a, b))
    for (ja, ta) in zip(pairs[0], pairs[1]):
        _per_doc_close(jm.infer(ja, iter=5), pm.infer(ta, iter=5), "LDA")
    assert len(jm._infer_cache) == 1
    ga, gb = (pm.infer(c, iter=5).gamma for c in pairs[1])
    assert not np.allclose(ga, gb)


def test_predict_raises_as_jax(trained, corpora):
    jl, pl = _frozen("LDA", trained, corpora)
    jc, pc = _frozen("CTPF", trained, corpora)
    jtest, ttest = corpora["jax"][1], corpora["torch"][1]
    renamed = {}
    for name, test in (("jax", jtest), ("torch", ttest)):
        r = test.copy()
        r.vocab[1] = "renamed"
        renamed[name] = r
    for kw in (dict(train_model=(jc, pc)), dict(corp=(renamed["jax"], renamed["torch"])),
               dict(tol=-1.0), dict(iter=-1)):
        corp = kw.pop("corp", (jtest, ttest))
        model = kw.pop("train_model", (jl, pl))
        a = _outcome(lambda: tm.predict(corp[0], model[0], **kw))
        b = _outcome(lambda: tt.predict(corp[1], model[1], **kw))
        assert a[0] != "ok" and a == b


@pytest.mark.parametrize("fam", ["LDA", "fLDA", "CTM", "fCTM"])
def test_gencorp_draws_as_jax(fam, trained, corpora):
    jm, pm = _frozen(fam, trained, corpora)
    a = tm.gencorp(jm, 25, laplace_smooth=0.01, seed=4)
    b = tt.gencorp(pm, 25, laplace_smooth=0.01, seed=4)
    assert [(d.terms, d.counts) for d in a.docs] == [(d.terms, d.counts) for d in b.docs]
    assert a.vocab == b.vocab and a.users == b.users and sum(len(d) for d in b.docs) > 0
    d1 = tm.gendoc(jm, rng=np.random.default_rng(2))
    d2 = tt.gendoc(pm, rng=np.random.default_rng(2))
    assert (d1.terms, d1.counts) == (d2.terms, d2.counts)


def test_gendoc_errors_as_jax(trained, corpora):
    jc, pc = _frozen("CTPF", trained, corpora)
    jl, pl = _frozen("LDA", trained, corpora)
    for args in (((jc, pc), {}), ((jl, pl), dict(laplace_smooth=-1.0))):
        (jm, pm), kw = args
        a, b = _outcome(lambda: tm.gendoc(jm, **kw)), _outcome(lambda: tt.gendoc(pm, **kw))
        assert a[0] != "ok" and a == b
    for kw in (dict(M=0), dict(M=3, laplace_smooth=-0.5)):
        a, b = _outcome(lambda: tm.gencorp(jl, **kw)), _outcome(lambda: tt.gencorp(pl, **kw))
        assert a[0] == "ValueError" and a == b


def test_model_without_device_needs_cuda(corpora):
    """A model built without ``device=`` runs on the CUDA device; with no
    CUDA device it raises rather than fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: tests/test_torch_cuda.py builds the model there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tt.LDA(corpora["torch"][0], K)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tt.CTPF(corpora["torch"][0], K)
