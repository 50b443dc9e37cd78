"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version; the JAX side runs
its Pallas kernel in interpret mode, as the JAX package's own tests do.
Inputs are drawn with numpy; the topic axis is padded to Kp = 128 on the
JAX side only.  Tolerances are the JAX package's own for Pallas vs XLA in
f32: rtol 5e-3, atol 1e-5 on the state and rows (tests/test_kernels.py),
1e-5 relative on the bound.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.special import digamma

from topicmodelsvb_jl_tpu.kernels.lda_elbo import lda_elbo_tok as jax_elbo_tok
from topicmodelsvb_jl_tpu.kernels.lda_estep import lda_estep as jax_estep
from topicmodelsvb_jl_torch.kernels import _build
from topicmodelsvb_jl_torch.kernels.lda_elbo import lda_elbo_tok, lda_elbo_tok_ref
from topicmodelsvb_jl_torch.kernels.lda_estep import lda_estep, lda_estep_ref
from topicmodelsvb_jl_torch.utils.numerics import EPSILON

KP = 128


def _inputs(K, B=16, L=24, V=40, seed=3):
    """One chunk of documents with a warm state; the last 3 are padding."""
    r = np.random.default_rng(seed)
    beta = r.dirichlet(np.ones(V), size=K)                      # [K, V]
    terms = r.integers(0, V, size=(B, L)).astype(np.int32)
    counts = (1 + r.poisson(0.4, size=(B, L))).astype(np.float32)
    n = r.integers(3, L, size=B)
    valid = np.arange(L)[None, :] < n[:, None]
    counts *= valid
    terms *= valid
    doc_mask = np.ones(B, np.float32)
    doc_mask[-3:] = 0.0
    counts[-3:] = 0.0
    alpha = r.uniform(0.2, 1.5, K)
    gamma = alpha + r.uniform(0.1, 5.0, size=(B, K))
    El = digamma(gamma) - digamma(gamma.sum(-1, keepdims=True))
    El_old = El + r.normal(0, 0.05, size=(B, K))
    f = lambda a: np.asarray(a, np.float32)
    return dict(beta=f(beta), beta_old=f(r.dirichlet(np.ones(V), size=K)),
                terms=terms, counts=counts, doc_mask=doc_mask, alpha=f(alpha),
                gamma=f(gamma), El=f(El), El_old=f(El_old))


def _padk(a):
    return jnp.pad(jnp.asarray(a), [(0, 0)] * (a.ndim - 1) + [(0, KP - a.shape[-1])])


def _estep_args(x):
    t = lambda a: torch.tensor(a)
    betaT = t(x["beta"].T + np.float32(EPSILON))
    return (betaT, t(x["terms"]), t(x["counts"]), t(x["doc_mask"]), t(x["alpha"]),
            t(x["gamma"]), t(x["El"]), t(x["El_old"]))


def _jax_estep(x, K, viter, vtol):
    betaT_p = _padk(x["beta"].T + np.float32(EPSILON))
    out = jax_estep(betaT_p[jnp.asarray(x["terms"])], jnp.asarray(x["counts"]),
                    jnp.asarray(x["doc_mask"]), _padk(x["alpha"]),
                    _padk(x["gamma"]), _padk(x["El"]), _padk(x["El_old"]),
                    viter=viter, vtol=vtol, n_topics=K, interpret=True)
    return [np.asarray(o)[..., :K] for o in out]


@pytest.mark.parametrize("K", [7, 16])
def test_lda_estep_ref_matches_pallas(K):
    x = _inputs(K)
    vtol = 1.0 / K**2
    want = _jax_estep(x, K, viter=6, vtol=vtol)
    got = lda_estep_ref(*_estep_args(x), viter=6, vtol=vtol)
    for name, a, b in zip(("gamma", "El", "El_old", "w"), got, want):
        np.testing.assert_allclose(a.numpy(), b, rtol=5e-3, atol=1e-5,
                                   err_msg=f"{name} diverged")


def test_lda_estep_wrapper_takes_plain_version_on_cpu():
    x = _inputs(7)
    before = lda_estep.launches
    got = lda_estep(*_estep_args(x), viter=5, vtol=1e-3)
    want = lda_estep_ref(*_estep_args(x), viter=5, vtol=1e-3)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert lda_estep.launches == before


def test_lda_estep_padded_doc_rows_frozen():
    """Padded documents (mask 0) keep their state bit for bit, w = 0."""
    x = _inputs(8)
    g, el, elo, w = lda_estep(*_estep_args(x), viter=4, vtol=1e-6)
    np.testing.assert_array_equal(g.numpy()[-3:], x["gamma"][-3:])
    np.testing.assert_array_equal(el.numpy()[-3:], x["El"][-3:])
    np.testing.assert_array_equal(elo.numpy()[-3:], x["El_old"][-3:])
    assert torch.all(w[-3:] == 0.0)
    assert not np.array_equal(g.numpy()[:-3], x["gamma"][:-3])


def test_lda_estep_stops_per_document():
    """viter = 0 leaves every state as it came; a loose vtol stops each
    document after its first pass (the reference's per-doc break)."""
    x = _inputs(7)
    g0, el0, elo0, _ = lda_estep_ref(*_estep_args(x), viter=0, vtol=1e-3)
    assert torch.equal(g0, torch.tensor(x["gamma"]))
    assert torch.equal(elo0, torch.tensor(x["El_old"]))
    g1, el1, elo1, _ = lda_estep_ref(*_estep_args(x), viter=1, vtol=1e9)
    g9, el9, elo9, _ = lda_estep_ref(*_estep_args(x), viter=9, vtol=1e9)
    assert torch.equal(g1, g9) and torch.equal(el1, el9)
    assert torch.equal(elo1[:-3], torch.tensor(x["El"][:-3]))


def _elbo_tables(x):
    bo = x["beta_old"].T + np.float32(EPSILON)
    g2 = bo * (np.log(x["beta"].T + np.float32(EPSILON)) - np.log(bo))
    return bo.astype(np.float32), g2.astype(np.float32)


@pytest.mark.parametrize("K", [7, 16])
def test_lda_elbo_tok_ref_matches_pallas(K):
    x = _inputs(K, seed=5)
    bo, g2 = _elbo_tables(x)
    tab = jnp.concatenate([_padk(bo), _padk(g2)], axis=1)[jnp.asarray(x["terms"])]
    want = float(jax_elbo_tok(tab, jnp.asarray(x["counts"]), jnp.asarray(x["doc_mask"]),
                              _padk(x["El"]), _padk(x["El_old"]), interpret=True))
    t = lambda a: torch.tensor(a)
    args = (t(bo), t(g2), t(x["terms"]), t(x["counts"]), t(x["doc_mask"]),
            t(x["El"]), t(x["El_old"]))
    got = float(lda_elbo_tok_ref(*args))
    assert abs(got - want) / abs(want) < 1e-5, (got, want)
    before = lda_elbo_tok.launches
    assert torch.equal(lda_elbo_tok(*args), lda_elbo_tok_ref(*args))
    assert lda_elbo_tok.launches == before


def test_lda_elbo_tok_masks_empty_slots():
    """A raw beta_old column of zeros under a padding slot (c = 0) gives
    s = 0 there; the masked terms keep the bound finite."""
    x = _inputs(7, seed=6)
    bo, g2 = _elbo_tables(x)
    bo[0] = 0.0
    g2[0] = 0.0
    t = lambda a: torch.tensor(a)
    counts = x["counts"].copy()
    counts[x["terms"] == 0] = 0.0
    out = lda_elbo_tok_ref(t(bo), t(g2), t(x["terms"]), t(counts), t(x["doc_mask"]),
                           t(x["El"]), t(x["El_old"]))
    assert torch.isfinite(out)


def test_wrappers_raise_on_a_device_without_kernel():
    args = [a.to("meta") for a in _estep_args(_inputs(4))]
    with pytest.raises(ValueError, match="no kernel"):
        lda_estep(*args, viter=2, vtol=1e-3)
    with pytest.raises(ValueError, match="no kernel"):
        lda_elbo_tok(args[0], args[0], args[1], args[2], args[3], args[5], args[6])


def test_require_names_the_bad_argument():
    a = torch.zeros(3, 4)
    _build.require("k", a.device, {"a": (a, (3, 4), torch.float32)})
    with pytest.raises(TypeError, match="b must be"):
        _build.require("k", a.device, {"b": (a.double(), (3, 4), torch.float32)})
    with pytest.raises(ValueError, match="shape"):
        _build.require("k", a.device, {"c": (a, (4, 3), torch.float32)})
    with pytest.raises(ValueError, match="contiguous"):
        _build.require("k", a.device, {"d": (a.T, (4, 3), torch.float32)})


def test_build_library_name_tracks_sources_and_needs_nvcc(monkeypatch, tmp_path):
    """The library name is a hash of the sources, so a stale build is
    never loaded; without nvcc the build raises instead of falling back."""
    p = _build.library_path()
    assert p.parent == _build.BUILD_DIR and p == _build.library_path()
    names = {s.name for s in _build._sources()}
    assert {"lda_estep.cu", "lda_elbo.cu", "common.cuh"} <= names
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
