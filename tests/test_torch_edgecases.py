"""Degenerate inputs on the port, held against the JAX package, on CPU.

The twelve tests (sixteen cases) of the JAX package's
``tests/test_edgecases.py``: K = 1, a one-document corpus, empty
documents, an all-empty corpus, one reader, one DTM slice, V = 1, counts
near 1e4, a 2,000-token document, alpha = 1e12, mu = ±800 and a corrupted
``invsigma``.  Each case asserts what its JAX twin asserts, on the port
with ``device="cpu"`` in float64.  Where both packages can train from one
init (K = 1 for LDA, fLDA, CTM and fCTM; the empty document for LDA and
CTM; the huge alpha; the large mu) the port also trains from the JAX
model's init, copied in through ``convert.state_for``, and its ELBO trace
and every global of its state agree with the JAX package's within 1e-8
relative at every iteration (the tolerance of the port's parity tests).
"""

import dataclasses

import numpy as np
import pytest
import torch

import topicmodelsvb_jl_tpu as tm
from topicmodelsvb_jl_tpu.parallel.mesh import make_mesh
from topicmodelsvb_jl_tpu.utils.config import RuntimeConfig as JaxRuntimeConfig
import topicmodelsvb_jl_torch as tt
from topicmodelsvb_jl_torch import convert
from topicmodelsvb_jl_torch.api import TopicModelError
from topicmodelsvb_jl_torch.validate import check_model

RTOL = 1e-8


def _rt():
    return tt.RuntimeConfig(chunk_docs=8, dtype="float64", pad_multiple=8)


def _port(cls, corp, K, **kw):
    return getattr(tt, cls)(corp, K, _rt(), device="cpu", **kw)


def _jax(cls, corp, K, **kw):
    return getattr(tm, cls)(corp, K, runtime=JaxRuntimeConfig(
        chunk_docs=8, dtype="float64", pad_multiple=8), mesh=make_mesh(n_devices=1), **kw)


def _host_state(state) -> dict:
    if dataclasses.is_dataclass(state):
        return {f.name: getattr(state, f.name).detach().cpu().numpy()
                for f in dataclasses.fields(state)}
    return {k: np.asarray(v) for k, v in state._asdict().items()}


def _record_steps(model) -> list:
    """The host state after every step of the model's next ``train``."""
    seen, build = [], model._build_trainer

    def build_recording(cfg):
        trainer = build(cfg)
        step = trainer.step_fn

        def recording(state, *data):
            state = step(state, *data)
            seen.append(_host_state(state))
            return state

        trainer.step_fn = recording
        return trainer

    model._build_trainer = build_recording
    return seen


def _train_jax(cls, pkg_corp, K, changes, train_kw):
    """The JAX model from its init edited by ``changes``, trained: the
    host state after every step, the ELBO trace, the init."""
    jm = _jax(cls, pkg_corp(tm), K, seed=3)
    init = _host_state(jm.state)
    jm.state = jm.state._replace(**changes)
    seen = _record_steps(jm)
    jm.train(**train_kw)
    return seen, [r.elbo for r in jm.trainer.trace], init


def _rel(got, want) -> float:
    """The largest difference over the largest magnitude of ``want``."""
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


def _pair(cls, pkg_corp, K, changes=None, spread=None, **train_kw):
    """The JAX model and the port's, the port's state the JAX init (each
    with the fields of ``changes`` put in its place), both trained
    with ``train_kw``; asserts the ELBO traces and the globals agree within
    1e-8 relative at every iteration (element by element, with a floor of
    1e-8 times the field's largest magnitude: a matrix entry that cancels
    to ~0 carries the rounding of the field's largest).

    ``spread`` names an edited field where the case is ill-conditioned:
    then the ELBO trace and that field are held instead to four times the
    JAX package's own spread, the largest distance from its straight run
    of two JAX runs whose ``spread`` starts one ulp up and one ulp down.
    The port's distance from JAX measures at most 1.6 times that spread;
    four leaves room for a spread taken from two runs only, which
    estimates rounding noise loosely.  Returns the port's model."""
    changes = changes or {}
    jseen, jtrace, init = _train_jax(cls, pkg_corp, K, changes, train_kw)
    pm = _port(cls, pkg_corp(tt), K, seed=3)
    pm.state = convert.state_for(pm, {**init, **changes})
    pseen = _record_steps(pm)
    pm.train(**train_kw)
    ptrace = [r.elbo for r in pm.trainer.trace]
    assert len(pseen) == len(jseen) == len(ptrace) == len(jtrace) >= 1   # tol may stop both
    assert None not in jtrace
    loose = {}
    if spread:
        for way in (np.inf, 0.0):
            moved = {**changes, spread: np.nextafter(changes[spread], way)}
            oseen, otrace, _ = _train_jax(cls, pkg_corp, K, moved, train_kw)
            assert len(otrace) == len(jtrace)
            for it in range(len(jtrace)):
                for f, a, b in (("elbo", otrace[it], jtrace[it]),
                                (spread, oseen[it][spread], jseen[it][spread])):
                    loose[f, it] = max(loose.get((f, it), 0.0), 4 * _rel(a, b))
    per_doc = set(type(pm)._per_doc_fields)
    for it, (js, ps) in enumerate(zip(jseen, pseen)):
        if ("elbo", it) in loose:
            assert _rel(ptrace[it], jtrace[it]) <= loose["elbo", it], (it, ptrace, jtrace)
        else:
            np.testing.assert_allclose(ptrace[it], jtrace[it], rtol=RTOL,
                                       err_msg=f"{cls} ELBO at iteration {it + 1}")
        for f, want in js.items():
            if f in per_doc or f == "elbo":
                continue
            if (f, it) in loose:
                assert _rel(ps[f], want) <= loose[f, it], (f, it + 1, ps[f], want)
                continue
            np.testing.assert_allclose(ps[f], want, rtol=RTOL,
                                       atol=RTOL * float(np.abs(want).max(initial=0.0)),
                                       err_msg=f"{cls} {f} at iteration {it + 1}")
    return pm


def _k1_corp(pkg):
    return pkg.Corpus(docs=[pkg.Document(terms=[1, 2, 3], counts=[2, 1, 1])],
                      vocab={1: "a", 2: "b", 3: "c"})


@pytest.mark.parametrize("cls", ["LDA", "fLDA", "CTM", "fCTM"])
def test_k1_single_doc(cls):
    """K = 1 and a one-document corpus train; the JAX twin's checks, then
    the same from the JAX init against the JAX package."""
    kw = dict(iter=3, checkelbo=1, printelbo=False, niter=20)
    own = _port(cls, _k1_corp(tt), 1)
    own.train(**kw)
    for m in (own, _pair(cls, _k1_corp, 1, **kw)):
        assert np.isfinite(m.elbo)
        td = m.topicdist(1)
        assert td.shape == (1,) and np.isclose(float(td.sum()), 1.0)


def _empty_doc_corp(pkg):
    docs = [pkg.Document(terms=[1, 2], counts=[2, 1]),
            pkg.Document(),                       # empty
            pkg.Document(terms=[2, 3], counts=[1, 3])]
    return pkg.Corpus(docs=docs, vocab={1: "a", 2: "b", 3: "c"})


@pytest.mark.parametrize("cls", ["LDA", "CTM"])
def test_empty_doc_in_corpus(cls):
    """A zero-token document poisons no statistic and no bound."""
    kw = dict(iter=4, checkelbo=1, printelbo=False, niter=20)
    own = _port(cls, _empty_doc_corp(tt), 2)
    own.train(**kw)
    for m in (own, _pair(cls, _empty_doc_corp, 2, **kw)):
        assert np.isfinite(m.elbo)
        deltas = [r.delta_elbo for r in m.trainer.trace if r.delta_elbo is not None]
        assert all(d > -1e-6 for d in deltas[1:])


def test_all_empty_corpus_zeroes_iterations():
    """An all-empty corpus zeroes the iteration count (LDA.jl:166)."""
    corp = tt.Corpus(docs=[tt.Document(), tt.Document()], vocab={1: "a"})
    m = _port("LDA", corp, 2)
    m.train(iter=10, checkelbo=1, printelbo=False)
    assert len(m.trainer.trace) == 0


def test_ctpf_single_reader_and_k1():
    corp = tt.Corpus(
        docs=[tt.Document(terms=[1, 2], counts=[1, 1], readers=[1], ratings=[1]),
              tt.Document(terms=[2, 3], counts=[2, 1], readers=[1], ratings=[2])],
        vocab={1: "a", 2: "b", 3: "c"}, users={1: "u"})
    m = _port("CTPF", corp, 1)
    m.train(iter=3, checkelbo=1, printelbo=False)
    assert np.isfinite(m.elbo)
    assert m.drecs[0] == [] or isinstance(m.drecs[0], (list, tuple))


def test_dtm_single_slice():
    """All stamps in one window: T = 1, one static slice, and it trains."""
    docs = [tt.Document(terms=[1, 2], counts=[1, 1], stamp=0.1),
            tt.Document(terms=[2, 3], counts=[2, 1], stamp=0.2),
            tt.Document(terms=[1, 3], counts=[1, 2], stamp=0.3)]
    corp = tt.Corpus(docs=docs, vocab={1: "a", 2: "b", 3: "c"})
    m = tt.DTM(corp, 2, delta=5.0, runtime=_rt(), device="cpu")
    assert m.T == 1
    m.train(iter=3, checkelbo=1, printelbo=False, cgiter=3)
    assert np.isfinite(m.elbo)


@pytest.mark.parametrize("counts", [(4, 2), (5, 2)], ids=["single_token_vocab", "vocab_of_one"])
def test_vocab_of_one(counts):
    """V = 1: beta is a [K, 1] all-ones matrix, and nothing divides by
    zero (the JAX package's ``test_single_token_vocab`` and
    ``test_vocab_of_one``, one case each)."""
    corp = tt.Corpus(docs=[tt.Document(terms=[1], counts=[c]) for c in counts],
                     vocab={1: "only"})
    m = _port("LDA", corp, 2)
    m.train(iter=3, checkelbo=1, printelbo=False)
    assert np.isfinite(m.elbo)
    np.testing.assert_allclose(np.asarray(m.beta), 1.0)
    assert np.allclose(np.asarray(m.beta).sum(axis=1), 1.0)


def test_huge_counts():
    """Counts near 1e4 keep CTPF's E[log y!] and every f64 sum finite."""
    rng = np.random.default_rng(0)
    docs = []
    for _ in range(8):
        terms = list(rng.choice(np.arange(1, 13), size=6, replace=False))
        counts = [int(c) for c in rng.integers(1, 10_000, size=6)]
        readers = [int(r) for r in rng.choice(np.arange(1, 5), 2, replace=False)]
        docs.append(tt.Document(terms=terms, counts=counts, readers=readers, ratings=[1, 1]))
    corp = tt.Corpus(docs=docs, vocab={j: f"w{j}" for j in range(1, 13)},
                     users={u: f"u{u}" for u in range(1, 5)})
    for cls in ("LDA", "CTPF"):
        m = _port(cls, corp, 2)
        m.train(iter=3, checkelbo=1, printelbo=False)
        assert np.isfinite(m.elbo), cls


def test_single_very_long_doc():
    """One 2,000-token document: gamma's mass is alpha's plus the tokens."""
    rng = np.random.default_rng(1)
    terms = [int(t) for t in rng.integers(1, 40, size=2000)]
    corp = tt.Corpus(docs=[tt.Document(terms=terms, counts=[1] * 2000)],
                     vocab={j: f"w{j}" for j in range(1, 40)})
    tt.condense_corp(corp)
    tt.compact_corp(corp)
    m = _port("LDA", corp, 3)
    m.train(iter=3, checkelbo=1, printelbo=False)
    assert np.isfinite(m.elbo)
    g = np.asarray(m.gamma)
    assert g.sum() > 2000 and np.all(g > 0)
    assert np.isclose(float(np.sum(m.topicdist(1))), 1.0)


def _small_corp(pkg, seed=0, V=12, M=10):
    rng = np.random.default_rng(seed)
    docs = []
    for _ in range(M):
        terms = list(rng.choice(np.arange(1, V + 1), size=6, replace=False))
        counts = [int(c) for c in rng.integers(1, 5, size=6)]
        docs.append(pkg.Document(terms=terms, counts=counts))
    return pkg.Corpus(docs=docs, vocab={j: f"w{j}" for j in range(1, V + 1)})


def test_lda_survives_huge_alpha():
    """alpha = 1e12 trains finitely and the Newton brings it back (the
    reference's todo.txt:22); the port's own init, then the JAX init
    against the JAX package.  The Newton's gradient there is a difference
    of terms near 1.1 that cancel to ~1e-12, so one ulp of ψ moves alpha
    by ~1e-3: alpha and the bound are held to the JAX package's own
    one-ulp spread, beta to 1e-8."""
    own = _port("LDA", _small_corp(tt, seed=3), 3)
    own.state = dataclasses.replace(own.state, alpha=torch.full((3,), 1e12,
                                                                dtype=torch.float64))
    own.train(iter=5, checkelbo=1, printelbo=False)
    pair = _pair("LDA", lambda pkg: _small_corp(pkg, seed=3), 3,
                 changes={"alpha": np.full(3, 1e12)}, spread="alpha",
                 iter=5, checkelbo=1, printelbo=False)
    for m in (own, pair):
        assert np.isfinite(m.elbo)
        assert np.all(np.isfinite(m.alpha)) and np.all(m.alpha > 0)
        assert np.all(np.isfinite(m.Elogtheta))
        assert np.all(np.isfinite(m.beta)) and np.all(np.isfinite(m.gamma))


def test_ctm_survives_large_mu():
    """mu = ±800, past f64's exp overflow: every Gaussian parameter stays
    finite and a topic the prior kills renormalises to the uniform row
    (the reference's todo.txt:8/11)."""
    mu = np.array([800.0, -800.0, 0.0])
    own = _port("CTM", _small_corp(tt, seed=4), 3)
    own.state = dataclasses.replace(own.state, mu=torch.tensor(mu))
    own.train(iter=5, checkelbo=1, printelbo=False, niter=30)
    pair = _pair("CTM", lambda pkg: _small_corp(pkg, seed=4), 3,
                 changes={"mu": mu},
                 iter=5, checkelbo=1, printelbo=False, niter=30)
    for m in (own, pair):
        s = _host_state(m.state)
        for name in ("mu", "sigma", "invsigma", "lam", "vsq", "logzeta"):
            assert np.all(np.isfinite(s[name])), name
        beta = np.asarray(m.beta)
        assert np.all(np.isfinite(beta))
        np.testing.assert_allclose(beta.sum(axis=1), 1.0, rtol=1e-9)
        assert np.isfinite(m.elbo)


def test_ctm_invsigma_corruption_rejected():
    """check_model requires a finite invsigma (the reference's todo.txt:7)."""
    m = _port("CTM", _small_corp(tt, seed=5), 3)
    bad = m.state.invsigma.clone()
    bad[0, 0] = float("inf")
    m.state = dataclasses.replace(m.state, invsigma=bad)
    with pytest.raises(TopicModelError):
        check_model(m)
