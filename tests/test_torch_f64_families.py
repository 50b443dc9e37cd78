"""Float64 on every family: the plain versions of the kernels that gained a
float64 mode (``ctpf_estep``, ``hmtm_estep``, ``hmtm_logz`` and the pass
modes ``lda_estep_pass``, ``flda_estep_pass``, ``ctpf_estep_pass``) in
float64 against the JAX package in float64, on the CPU, from one numpy
seed.

* ``ctpf_estep_ref`` against the JAX package's Pallas ``ctpf_estep`` in
  interpret mode (x64 enabled, as tests/conftest.py sets it): rtol 1e-10.
* The pass modes against the per-pass bodies the JAX package runs in XLA
  where a document's slots are split over ranks (models/lda.py:127,
  models/flda.py:91, models/ctpf.py:127): rtol 1e-10.  CTPF's body takes
  ψ(gimel), ψ(zayin) from ``digamma``, the port's pass from the kernels'
  shift-by-8 series (truncation ~2.5e-10 at x + 8 = 8); it is held at
  1e-10 to the body with the JAX package's own series in place of
  ``digamma`` and at 1e-9 to the body as it is.
* ``hmtm_estep_ref``/``hmtm_logz_ref`` at K = 240 and 300, the widths the
  card's wide mode takes, against JAX ``_estep_chunk``/``_forward``:
  rtol 1e-10.
* A small float64 CTPF and HMTM trained 3 iterations in both packages from
  one init: 1e-8 a iteration on the bound and the globals (the JAX
  package's oracle tolerance).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.special import digamma

import topicmodelsvb_jl_tpu as tm
from topicmodelsvb_jl_tpu.kernels.ctpf_estep import ctpf_estep as jax_ctpf_estep
from topicmodelsvb_jl_tpu.kernels.lda_estep import digamma_series as jax_digamma_series
from topicmodelsvb_jl_tpu.models import ctpf as jax_ctpf
from topicmodelsvb_jl_tpu.models import flda as jax_flda
from topicmodelsvb_jl_tpu.models import hmtm as jax_hmtm
from topicmodelsvb_jl_tpu.models import lda as jax_lda
from topicmodelsvb_jl_tpu.ops.packing import pack_corpus as jax_pack
from topicmodelsvb_jl_tpu.parallel.mesh import make_mesh
from topicmodelsvb_jl_tpu.utils.config import RuntimeConfig as JaxRuntimeConfig
import topicmodelsvb_jl_torch as tt
from topicmodelsvb_jl_torch import convert
from topicmodelsvb_jl_torch.kernels.ctpf_estep import (
    ctpf_estep, ctpf_estep_pass, ctpf_estep_pass_ref, ctpf_estep_ref,
)
from topicmodelsvb_jl_torch.kernels.flda_estep import flda_estep_pass, flda_estep_pass_ref
from topicmodelsvb_jl_torch.kernels.hmtm_estep import (
    hmtm_estep, hmtm_estep_ref, hmtm_logz, hmtm_logz_ref,
)
from topicmodelsvb_jl_torch.kernels.lda_estep import lda_estep_pass, lda_estep_pass_ref
from topicmodelsvb_jl_torch.utils.numerics import EPSILON

RTOL = 1e-10   # a float64 plain version against the JAX package in float64
KP = 128
HYP = dict(c_hyper=0.1, g_hyper=0.1)


def _t(a):
    return torch.tensor(np.asarray(a))


def _close(name, got, want, rtol=RTOL, atol=1e-14):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.dtype == np.float64, name
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol, err_msg=name)


def _launches(*fns):
    return [(f.launches, f.launches_double) for f in fns]


# ── CTPF ──

def _ctpf_inputs(K, B=16, L=24, R=8, V=40, U=12, seed=3):
    """One chunk with a warm state, in float64, and the globals it comes
    from; the last 3 documents are padding."""
    r = np.random.default_rng(seed)
    alef = 0.1 + r.gamma(2.0, 1.0, size=(K, V))
    he = 0.1 + r.gamma(2.0, 1.0, size=(K, U))
    terms = r.integers(0, V, size=(B, L)).astype(np.int32)
    counts = (1.0 + r.poisson(0.4, size=(B, L))) * (
        np.arange(L)[None, :] < r.integers(3, L, size=B)[:, None])
    readers = r.integers(0, U, size=(B, R)).astype(np.int32)
    ratings = (np.arange(R)[None, :] < r.integers(1, R, size=B)[:, None]).astype(np.float64)
    terms[counts == 0] = 0
    readers[ratings == 0] = 0
    doc_mask = np.ones(B)
    doc_mask[-3:] = 0.0
    counts[-3:] = 0.0
    ratings[-3:] = 0.0
    dalet, bet, vav, het = (r.uniform(0.5, 3.0, K) for _ in range(4))
    gimel = 0.1 + r.gamma(2.0, 1.0, size=(B, K))
    zayin = 0.1 + r.gamma(2.0, 1.0, size=(B, K))
    return dict(dg_alefT=digamma(alef).T, dg_heT=digamma(he).T, dalet=dalet, bet=bet, vav=vav,
                het=het, ealefT=np.exp(digamma(alef)).T, eheT=np.exp(digamma(he)).T,
                terms=terms, counts=counts, readers=readers, ratings=ratings,
                doc_mask=doc_mask, inv_db=1 / (dalet * bet), inv_dv=1 / (dalet * vav),
                inv_hv=1 / (het * vav), gimel=gimel, gimel_old=gimel * 1.1, zayin=zayin,
                zayin_old=zayin * 0.9)


CTPF_ARGS = ("ealefT", "eheT", "terms", "counts", "readers", "ratings", "doc_mask",
             "inv_db", "inv_dv", "inv_hv", "gimel", "gimel_old", "zayin", "zayin_old")


@pytest.mark.parametrize("K", [7, 16])
def test_ctpf_estep_ref_f64_matches_jax(K):
    """Padded to Kp = 128 by the JAX package's conventions (models/ctpf.py:
    229-245): tables, the [K] vectors and the state padded with 0."""
    x = _ctpf_inputs(K)
    vtol = 1.0 / K**2
    padk = lambda a: jnp.pad(jnp.asarray(a), [(0, 0)] * (a.ndim - 1) + [(0, KP - K)])
    want = jax_ctpf_estep(
        padk(x["ealefT"])[jnp.asarray(x["terms"])], padk(x["eheT"])[jnp.asarray(x["readers"])],
        jnp.asarray(x["counts"]), jnp.asarray(x["ratings"]), jnp.asarray(x["doc_mask"]),
        padk(x["inv_db"]), padk(x["inv_dv"]), padk(x["inv_hv"]),
        padk(x["gimel"]), padk(x["gimel_old"]), padk(x["zayin"]), padk(x["zayin_old"]),
        viter=6, vtol=vtol, n_topics=K, interpret=True, **HYP)
    assert want[0].dtype == jnp.float64
    args = tuple(_t(x[k]) for k in CTPF_ARGS)
    got = ctpf_estep_ref(*args, viter=6, vtol=vtol, **HYP)
    for name, a, b in zip(("gimel", "gimel_old", "zayin", "zayin_old", "wa", "wh"), got, want):
        _close(name, a, np.asarray(b)[..., :K])
    # on the CPU the wrapper is the plain version, and counts no launch
    n0 = _launches(ctpf_estep)
    assert all(torch.equal(a, b)
               for a, b in zip(ctpf_estep(*args, viter=6, vtol=vtol, **HYP), got))
    assert _launches(ctpf_estep) == n0


def _jax_ctpf_pass(x, dg):
    """The per-pass body of the JAX package's CTPF E-step on the sequence
    axis (models/ctpf.py:127-140), before its psum: (gsum, zsum)."""
    j = lambda k: jnp.asarray(x[k])
    dg_alef_d, dg_he_d = j("dg_alefT")[j("terms")], j("dg_heT")[j("readers")]
    log_dalet, log_het = jnp.log(j("dalet"))[None, :], jnp.log(j("het"))[None, :]
    log_bet, log_vav = jnp.log(j("bet"))[None, :], jnp.log(j("vav"))[None, :]
    dg_gimel, dg_zayin = dg(j("gimel")), dg(j("zayin"))
    xi_top, xi_bot = jax_ctpf._xi(dg_he_d, dg_gimel, dg_zayin, log_dalet, log_het, log_vav)
    p = jax_ctpf._phi(dg_alef_d, dg_gimel, log_dalet, log_bet)
    zsum = jnp.einsum("br,brk->bk", j("ratings"), xi_bot)
    gsum = (jnp.einsum("bl,blk->bk", j("counts"), p)
            + jnp.einsum("br,brk->bk", j("ratings"), xi_top))
    return gsum, zsum


@pytest.mark.parametrize("K", [7, 16])
def test_ctpf_estep_pass_ref_f64_matches_jax(K):
    x = _ctpf_inputs(K, seed=K)
    x["counts"][1], x["terms"][1] = 0.0, 0     # readers alone
    x["ratings"][2], x["readers"][2] = 0.0, 0   # tokens alone
    args = tuple(_t(x[k]) for k in CTPF_ARGS[:11] + ("zayin",))
    got = ctpf_estep_pass_ref(*args)
    act = x["doc_mask"] > 0
    for dg, rtol in ((jax_digamma_series, RTOL), (jax_ctpf.digamma, 1e-9)):
        want = _jax_ctpf_pass(x, dg)
        for name, a, b in zip(("gsum", "zsum"), got, want):
            _close(name, a[act], np.asarray(b)[act], rtol=rtol)
    assert all(torch.all(a[~torch.as_tensor(act)] == 0) for a in got)
    assert torch.all(got[1][2] == 0) and torch.all(got[0][1] > 0)
    n0 = _launches(ctpf_estep_pass)
    assert all(torch.equal(a, b) for a, b in zip(ctpf_estep_pass(*args), got))
    assert _launches(ctpf_estep_pass) == n0


# ── the LDA and fLDA pass modes ──

def _token_inputs(K, B=16, L=24, V=40, seed=3):
    r = np.random.default_rng(seed)
    beta = r.dirichlet(np.ones(V), size=K)
    terms = r.integers(0, V, size=(B, L)).astype(np.int32)
    counts = (1.0 + r.poisson(0.4, size=(B, L))) * (
        np.arange(L)[None, :] < r.integers(3, L, size=B)[:, None])
    terms[counts == 0] = 0
    doc_mask = np.ones(B)
    doc_mask[-3:] = 0.0
    gamma = r.uniform(0.2, 1.5, K) + r.uniform(0.1, 5.0, size=(B, K))
    El = digamma(gamma) - digamma(gamma.sum(-1, keepdims=True))
    return dict(betaT=beta.T + EPSILON, terms=terms, counts=counts, doc_mask=doc_mask, El=El,
                kappa=r.dirichlet(np.ones(V)), tau=r.uniform(0.1, 0.9, size=(B, L)))


@pytest.mark.parametrize("K", [7, 16])
def test_lda_estep_pass_ref_f64_matches_jax(K):
    """pc = phi@counts of the JAX package's LDA body (models/lda.py:127-132)
    with phi = softmax(log betaT[terms] + El)."""
    x = _token_inputs(K, seed=K + 1)
    want = jnp.einsum("bl,blk->bk", jnp.asarray(x["counts"]),
                      jax_lda._phi(jnp.log(jnp.asarray(x["betaT"]))[jnp.asarray(x["terms"])],
                                   jnp.asarray(x["El"])))
    args = tuple(_t(x[k]) for k in ("betaT", "terms", "counts", "doc_mask", "El"))
    got = lda_estep_pass_ref(*args)
    act = x["doc_mask"] > 0
    _close("pc", got[act], np.asarray(want)[act])
    assert torch.all(got[~torch.as_tensor(act)] == 0)
    n0 = _launches(lda_estep_pass)
    assert torch.equal(lda_estep_pass(*args), got) and _launches(lda_estep_pass) == n0


@pytest.mark.parametrize("K", [7, 16])
def test_flda_estep_pass_ref_f64_matches_jax(K):
    """pc = phi@counts and tau_new of the JAX package's fLDA body
    (models/flda.py:91-99), phi = softmax(tau log betaT[terms] + El)."""
    x = _token_inputs(K, seed=K + 2)
    eta = 0.6
    lbT = np.log(x["betaT"])
    j = lambda k: jnp.asarray(x[k])
    logbeta_d = jnp.asarray(lbT)[j("terms")]
    p = jax_flda._phi(logbeta_d, j("tau"), j("El"))
    s = jnp.sum(p * logbeta_d, axis=-1)
    tau_new = eta / (eta + (1.0 - eta) * j("kappa")[j("terms")] * jnp.exp(-s) + EPSILON)
    pc = jnp.einsum("bl,blk->bk", j("counts"), p)
    args = (_t(lbT), _t(x["kappa"]), _t(x["terms"]), _t(x["counts"]), _t(x["doc_mask"]),
            torch.tensor(eta, dtype=torch.float64), _t(x["El"]), _t(x["tau"]))
    got = flda_estep_pass_ref(*args)
    act = x["doc_mask"] > 0
    _close("pc", got[0][act], np.asarray(pc)[act])
    _close("tau_new", got[1][act], np.asarray(tau_new)[act])
    assert torch.all(got[0][~torch.as_tensor(act)] == 0)
    assert torch.equal(got[1][~torch.as_tensor(act)], args[7][~torch.as_tensor(act)])
    n0 = _launches(flda_estep_pass)
    assert all(torch.equal(a, b) for a, b in zip(flda_estep_pass(*args), got))
    assert _launches(flda_estep_pass) == n0


# ── HMTM at the wide mode's widths ──

def _hmtm_chunk(K, L=8, V=30, seed=0):
    """Two documents: one full, one with interior and trailing padding."""
    r = np.random.default_rng(seed)
    tmask = np.ones((2, L))
    tmask[1, 2] = tmask[1, L - 2:] = 0.0
    terms = r.integers(0, V, size=(2, L)).astype(np.int32) * (tmask > 0)
    return dict(betaT_eps=r.dirichlet(np.ones(V), size=K).T + EPSILON, terms=terms,
                tmask=tmask, doc_mask=np.ones(2), eta=r.uniform(0.5, 2.0, K),
                alpha=r.uniform(0.5, 2.0, (K, K)), tau=r.uniform(0.5, 3.0, (2, K)),
                gamma=r.uniform(0.5, 3.0, (2, K, K)))


@pytest.mark.parametrize("K", [240, 300])
def test_hmtm_refs_at_wide_k_match_jax(K):
    x = _hmtm_chunk(K, seed=K)
    j = {k: jnp.asarray(v) for k, v in x.items()}
    t = {k: _t(v) for k, v in x.items()}
    vtol = 1e-3
    jt, jg, _, _, _ = jax_hmtm._estep_chunk(
        j["betaT_eps"], j["eta"], j["alpha"], j["terms"], j["tmask"], j["doc_mask"], j["tau"],
        j["gamma"], 3, vtol, x["betaT_eps"].shape[0])
    tau, gamma, r = hmtm_estep_ref(t["betaT_eps"], t["terms"], t["tmask"], t["doc_mask"],
                                   t["eta"], t["alpha"], t["tau"], t["gamma"], viter=3, vtol=vtol)
    _close("tau", tau, jt)
    _close("gamma", gamma, jg)
    p0, A = jax_hmtm._tilde(jnp.asarray(tau.numpy()), jnp.asarray(gamma.numpy()))
    Bv = j["betaT_eps"][j["terms"]]
    a, c, logz = jax_hmtm._forward(p0, A, Bv, j["tmask"])
    _, _, jr = jax_hmtm._backward_stats(a, c, A, Bv, j["tmask"], with_r=True)
    _close("r", r, jr)
    assert torch.all(r[t["tmask"] == 0] == 0)
    zargs = (t["betaT_eps"], t["terms"], t["tmask"], tau, gamma)
    z = hmtm_logz_ref(*zargs)
    _close("logZ", z, logz)
    n0 = _launches(hmtm_estep, hmtm_logz)
    assert torch.equal(hmtm_logz(*zargs), z)
    assert all(torch.equal(u, v) for u, v in zip(
        hmtm_estep(*(t[k] for k in x), viter=3, vtol=vtol), (tau, gamma, r)))
    assert _launches(hmtm_estep, hmtm_logz) == n0


# ── small float64 models, 3 iterations from one init ──

def _trained_pair(jm, pm, fields):
    jm.train(iter=3, checkelbo=1, printelbo=False)
    pm.train(iter=3, checkelbo=1, printelbo=False)
    je = [r.elbo for r in jm.trainer.trace]
    pe = [r.elbo for r in pm.trainer.trace]
    assert len(je) == len(pe) == 3
    np.testing.assert_allclose(pe, je, rtol=1e-8)
    for f in fields:
        _close(f, np.asarray(getattr(pm, f)), np.asarray(getattr(jm, f)), rtol=1e-8, atol=1e-12)


def test_small_float64_ctpf_follows_jax():
    corpus = dict(M=60, V=50, K=3, U=20, seed=5, mean_tokens=20, mean_terms=10,
                  mean_readers=3)
    kw = dict(with_readers=True, pad_multiple=8, dtype=np.float64)
    jp, tp = jax_pack(tm.synth_corpus(**corpus), **kw), tt.pack_corpus(tt.synth_corpus(**corpus),
                                                                      **kw)
    jm = tm.CTPF(jp, 4, runtime=JaxRuntimeConfig(chunk_docs=16, dtype="float64"),
                 mesh=make_mesh(n_devices=1), seed=3)
    pm = tt.CTPF(tp, 4, tt.RuntimeConfig(chunk_docs=16, dtype="float64"), device="cpu", seed=3)
    pm.state = convert.ctpf_state_from_numpy(jm.state._asdict(), "cpu", torch.float64)
    _trained_pair(jm, pm, ("alef", "bet", "dalet", "he", "vav", "het"))


def test_small_float64_hmtm_follows_jax():
    corpus = dict(M=30, V=40, K=3, seed=11, mean_tokens=25, mean_terms=12)
    jc, tc = tm.synth_corpus(**corpus), tt.synth_corpus(**corpus)
    tm.expand_corp(jc)
    tt.expand_corp(tc)
    jm = tm.HMTM(jc, 4, runtime=JaxRuntimeConfig(chunk_docs=8, dtype="float64", pad_multiple=8),
                 mesh=make_mesh(n_devices=1), seed=3)
    pm = tt.HMTM(tc, 4, tt.RuntimeConfig(chunk_docs=8, dtype="float64", pad_multiple=8),
                 device="cpu", seed=3)
    pm.state = convert.hmtm_state_from_numpy(jm.state._asdict(), "cpu", torch.float64)
    _trained_pair(jm, pm, ("eta", "alpha", "beta"))
