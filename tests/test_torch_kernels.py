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


# ── the f64 Elogtheta channel (RuntimeConfig.elogtheta_f64) ──
#
# The plain versions with elogtheta_f64=True on a float32 state against the
# JAX package's XLA chunk bodies with elogtheta_f64=True (x64 enabled, as
# tests/conftest.py sets it).  Both take psi in float64 from the float32
# gamma and cast back; what separates them is float32 rounding elsewhere
# (the port forms phi multiplicatively, JAX as a softmax of logs):
# rtol 1e-5 / atol 1e-6 on every output.
F64_RTOL, F64_ATOL = 1e-5, 1e-6


def _edge_chunk(K, B=12, L=16, V=30, seed=8):
    """_inputs with an empty real document (0), a one-token one (1) and
    the last 3 masked."""
    x = _inputs(K, B=B, L=L, V=V, seed=seed)
    x["counts"][0] = 0.0
    x["terms"][0] = 0
    x["counts"][1] = 0.0
    x["counts"][1, 0] = 3.0
    return x


def _scatter(w, terms, V):
    out = np.zeros((V, w.shape[-1]), np.float64)
    np.add.at(out, terms.reshape(-1), w.reshape(-1, w.shape[-1]).astype(np.float64))
    return out


def test_lda_estep_ref_f64_channel_matches_jax_xla():
    from topicmodelsvb_jl_tpu.models.lda import _estep_chunk

    K, V, viter = 6, 30, 8
    x = _edge_chunk(K, V=V)
    vtol = 1.0 / K**2
    logbetaT = jnp.log(jnp.asarray(x["beta"]) + np.float32(EPSILON)).T
    j = _estep_chunk(logbetaT, jnp.asarray(x["alpha"]), jnp.asarray(x["terms"]),
                     jnp.asarray(x["counts"]), jnp.asarray(x["doc_mask"]),
                     jnp.asarray(x["gamma"]), jnp.asarray(x["El"]), jnp.asarray(x["El_old"]),
                     viter, vtol, V, elogtheta_f64=True)
    assert all(np.asarray(a).dtype == np.float32 for a in j[:3])
    got = lda_estep_ref(*_estep_args(x), viter=viter, vtol=vtol, elogtheta_f64=True)
    assert all(a.dtype == torch.float32 for a in got)
    for name, a, b in zip(("gamma", "El", "El_old"), got, j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=F64_RTOL, atol=F64_ATOL,
                                   err_msg=name)
    np.testing.assert_allclose(_scatter(got[3].numpy(), x["terms"], V), np.asarray(j[3]),
                               rtol=F64_RTOL, atol=F64_ATOL, err_msg="beta_temp")
    # the empty document moves to alpha + eps, the masked ones keep their state
    np.testing.assert_allclose(got[0][0].numpy(), x["alpha"] + np.float32(EPSILON), rtol=1e-7)
    np.testing.assert_array_equal(got[1][-3:].numpy(), x["El"][-3:])


def test_lda_estep_f64_channel_is_honoured():
    """The knob changes El (the float32 series and the float64 psi round
    differently), through the wrapper too; the float32 mode is unchanged."""
    x = _edge_chunk(7)
    off = lda_estep(*_estep_args(x), viter=6, vtol=1e-3)
    on = lda_estep(*_estep_args(x), viter=6, vtol=1e-3, elogtheta_f64=True)
    assert not torch.equal(off[1], on[1])
    for a, b in zip(off, lda_estep_ref(*_estep_args(x), viter=6, vtol=1e-3)):
        assert torch.equal(a, b)
    for a, b in zip(on, lda_estep_ref(*_estep_args(x), viter=6, vtol=1e-3,
                                      elogtheta_f64=True)):
        assert torch.equal(a, b)


def _flda_args(x, seed=4):
    r = np.random.default_rng(seed)
    B, L = x["terms"].shape
    V = x["beta"].shape[1]
    kappa = r.dirichlet(np.ones(V)).astype(np.float32)
    tau = r.uniform(0.1, 0.9, (B, L)).astype(np.float32)
    tau_old = r.uniform(0.1, 0.9, (B, L)).astype(np.float32)
    logbetaT = np.log(x["beta"].T + np.float32(EPSILON)).astype(np.float32)
    return dict(logbetaT=logbetaT, kappa=kappa, eta=np.float32(0.6), tau=tau, tau_old=tau_old)


def test_flda_estep_ref_f64_channel_matches_jax_xla():
    from topicmodelsvb_jl_tpu.models.flda import _estep_chunk
    from topicmodelsvb_jl_torch.kernels.flda_estep import flda_estep, flda_estep_ref

    K, V, viter = 6, 30, 8
    x = _edge_chunk(K, V=V, seed=9)
    f = _flda_args(x)
    vtol = 1.0 / K**2
    J = jnp.asarray
    j = _estep_chunk(J(f["logbetaT"]), J(f["kappa"]), J(f["eta"]), J(x["alpha"]),
                     J(x["terms"]), J(x["counts"]), J(x["doc_mask"]), J(x["gamma"]),
                     J(x["El"]), J(x["El_old"]), J(f["tau"]), J(f["tau_old"]), viter, vtol, V,
                     elogtheta_f64=True)
    t = torch.tensor
    args = (t(f["logbetaT"]), t(f["kappa"]), t(x["terms"]), t(x["counts"]), t(x["doc_mask"]),
            t(x["alpha"]), t(f["eta"]), t(x["gamma"]), t(x["El"]), t(x["El_old"]),
            t(f["tau"]), t(f["tau_old"]))
    got = flda_estep_ref(*args, viter=viter, vtol=vtol, elogtheta_f64=True)
    assert all(a.dtype == torch.float32 for a in got)
    for name, a, b in zip(("gamma", "El", "El_old", "tau", "tau_old"), got, j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=F64_RTOL, atol=F64_ATOL,
                                   err_msg=name)
    stat = _scatter(got[5].numpy(), x["terms"], V)
    np.testing.assert_allclose(stat[:, :K], np.asarray(j[5]), rtol=F64_RTOL, atol=F64_ATOL,
                               err_msg="beta_temp")
    np.testing.assert_allclose(stat[:, K], np.asarray(j[6]), rtol=F64_RTOL, atol=F64_ATOL,
                               err_msg="kappa_temp")
    off = flda_estep(*args, viter=viter, vtol=vtol)
    on = flda_estep(*args, viter=viter, vtol=vtol, elogtheta_f64=True)
    assert not torch.equal(off[1], on[1])
    assert all(torch.equal(a, b) for a, b in zip(on, got))


def test_split_fixpoint_f64_channel_equals_the_fused_plain_version():
    """The pass mode's driver takes the same float64 psi on its tiles:
    driven alone it gives the fused plain version's bits."""
    from topicmodelsvb_jl_torch.kernels.lda_estep import split_fixpoint

    x = _edge_chunk(5)
    a = split_fixpoint(*_estep_args(x), viter=7, vtol=1e-3, elogtheta_f64=True)
    b = lda_estep_ref(*_estep_args(x), viter=7, vtol=1e-3, elogtheta_f64=True)
    assert all(torch.equal(u, v) for u, v in zip(a, b))


@pytest.mark.parametrize("family", ["lda", "flda"])
def test_make_step_f64_channel_matches_jax(family):
    """LDA's and fLDA's make_step with elogtheta_f64 on a float32 state,
    against the JAX package's (XLA body, x64 enabled), 3 iterations from
    the JAX init.  Every field within rtol 1e-5 / atol 1e-6, as one chunk
    (the largest relative gap measured, 2.4e-6, is kappa's)."""
    import jax

    import topicmodelsvb_jl_tpu as tm
    import topicmodelsvb_jl_torch as tt
    from topicmodelsvb_jl_tpu.datasets import synth_packed_nsf_scale as jax_synth
    from topicmodelsvb_jl_tpu.models import flda as jax_flda
    from topicmodelsvb_jl_tpu.models import lda as jax_lda
    from topicmodelsvb_jl_tpu.parallel.mesh import make_mesh
    from topicmodelsvb_jl_tpu.utils.config import RuntimeConfig as JaxRuntimeConfig
    from topicmodelsvb_jl_torch import convert
    from topicmodelsvb_jl_torch.models import flda as torch_flda
    from topicmodelsvb_jl_torch.models import lda as torch_lda

    K, chunk = 5, 16
    corpus = dict(M=120, V=80, mean_terms=15, seed=2, chunk_docs=chunk)
    cls, jmod, tmod = {"lda": ("LDA", jax_lda, torch_lda),
                       "flda": ("fLDA", jax_flda, torch_flda)}[family]
    jm = getattr(tm, cls)(jax_synth(**corpus), K,
                          runtime=JaxRuntimeConfig(chunk_docs=chunk, elogtheta_f64=True),
                          mesh=make_mesh(n_devices=1), seed=4)
    pm = getattr(tt, cls)(tt.synth_packed_nsf_scale(**corpus), K,
                          tt.RuntimeConfig(chunk_docs=chunk, elogtheta_f64=True),
                          device="cpu", seed=4)
    pm.state = convert.state_for(pm, {k: np.asarray(v) for k, v in jm.state._asdict().items()})
    p = jm.packed
    kw = dict(viter=10, vtol=1.0 / K**2, niter=1000, ntol=1.0 / K**2, chunk_docs=chunk,
              elogtheta_f64=True)
    jstep = jax.jit(jmod.make_step(p, K, axis_name=None, use_pallas=False, **kw))
    tstep = tmod.make_step(pm.packed, K, device="cpu", **kw)
    jdata = tuple(tuple(jnp.asarray(getattr(s, f)) for s in p.segments)
                  for f in ("terms", "counts", "doc_mask"))
    tdata = pm._data_arrays()
    if family == "lda":
        jtot, ttot = (jnp.asarray(np.float32(p.M)),), (float(pm.M),)
    else:
        tot = (np.float32(p.M), np.float32(p.C.sum()))
        jtot, ttot = tuple(jnp.asarray(v) for v in tot), tuple(torch.tensor(v) for v in tot)
    js, ts = jm.state, pm.state
    for it in range(3):
        js = jstep(js, *jdata, *jtot)
        ts = tstep(ts, *tdata, *ttot)
    got = convert.lda_state_to_numpy(ts)
    for f, want in js._asdict().items():
        if f == "elbo":
            continue
        assert got[f].dtype == np.float32, f
        np.testing.assert_allclose(got[f], np.asarray(want), rtol=F64_RTOL, atol=F64_ATOL,
                                   err_msg=f)


# ── the pass modes of flda_estep and ctpf_estep (the sequence axis) ──

def _flda_split_args(viter, K=5):
    """fLDA E-step arguments on _edge_chunk: an empty real document, a
    one-token one and 3 masked, in float64."""
    x = _edge_chunk(K, seed=20 + viter)
    f = _flda_args(x, seed=viter)
    t = lambda a: torch.tensor(np.asarray(a), dtype=torch.float64)
    return (t(f["logbetaT"]), t(f["kappa"]), torch.tensor(x["terms"]), t(x["counts"]),
            t(x["doc_mask"]), t(x["alpha"]), t(f["eta"]), t(x["gamma"]), t(x["El"]),
            t(x["El_old"]), t(f["tau"]), t(f["tau_old"]))


def _ctpf_split_args(seed, K=5, B=12, L=16, R=6, V=30, U=9):
    """CTPF E-step arguments in float64: an empty real document (no tokens,
    no readers), a one-token one with no reader, a reader-only one and 3
    masked."""
    r = np.random.default_rng(seed)
    t = lambda a: torch.tensor(np.asarray(a), dtype=torch.float64)
    x = _edge_chunk(K, B=B, L=L, V=V, seed=seed)
    ratings = (np.arange(R)[None, :] < r.integers(1, R + 1, size=B)[:, None]).astype(float)
    ratings[:2] = 0.0
    ratings[-3:] = 0.0
    readers = r.integers(0, U, size=(B, R)).astype(np.int32) * (ratings > 0)
    counts = x["counts"].copy()
    counts[2] = 0.0                                   # readers alone
    gam = lambda *shape: t(0.1 + r.gamma(2.0, 1.0, size=shape))
    ealefT = torch.exp(torch.special.digamma(gam(K, V))).T.contiguous()
    eheT = torch.exp(torch.special.digamma(gam(K, U))).T.contiguous()
    dalet, bet, vav, het = (t(r.uniform(0.5, 3.0, K)) for _ in range(4))
    gimel, zayin = gam(B, K), gam(B, K)
    return (ealefT, eheT, torch.tensor(x["terms"]), t(counts), torch.tensor(readers),
            t(ratings), t(x["doc_mask"]), 1.0 / (dalet * bet), 1.0 / (dalet * vav),
            1.0 / (het * vav), gimel, gimel * 1.1, zayin, zayin * 0.9)


CTPF_HYPER = dict(c_hyper=0.1, g_hyper=0.1)


@pytest.mark.parametrize("viter", [0, 1, 3, 20])
def test_flda_split_fixpoint_without_collective_equals_flda_estep_ref(viter):
    from topicmodelsvb_jl_torch.kernels.flda_estep import flda_estep_ref, flda_split_fixpoint

    args = _flda_split_args(viter)
    want = flda_estep_ref(*args, viter=viter, vtol=1e-4)
    got = flda_split_fixpoint(*args, viter=viter, vtol=1e-4)
    for name, a, b in zip(("gamma", "El", "El_old", "tau", "tau_old", "w"), got, want):
        assert torch.equal(a, b), name
    if viter:   # the empty document's tau moves on its padding slots
        assert not torch.equal(got[3][0], args[10][0])


@pytest.mark.parametrize("viter", [0, 1, 3, 20])
def test_ctpf_split_fixpoint_without_collective_equals_ctpf_estep_ref(viter):
    from topicmodelsvb_jl_torch.kernels.ctpf_estep import ctpf_estep_ref, ctpf_split_fixpoint

    args = _ctpf_split_args(viter)
    want = ctpf_estep_ref(*args, viter=viter, vtol=1e-4, **CTPF_HYPER)
    got = ctpf_split_fixpoint(*args, viter=viter, vtol=1e-4, **CTPF_HYPER)
    for name, a, b in zip(("gimel", "gimel_old", "zayin", "zayin_old", "wa", "wh"), got, want):
        assert torch.equal(a, b), name


def test_flda_pass_over_split_slots_sums_to_the_whole_pass():
    """The fLDA pass mode's plain version on two halves of every document's
    slots: the statistics sum to the pass on the whole (a sum of per-slot
    terms, each with its own normaliser), the halves' tau side by side are
    the whole's; a masked document gets 0 and keeps its tau."""
    from topicmodelsvb_jl_torch.kernels.flda_estep import flda_estep_pass, flda_estep_pass_ref

    lb, kap, terms, counts, dm, _, eta, _, El, _, tau, _ = _flda_split_args(2)
    whole = flda_estep_pass(lb, kap, terms, counts, dm, eta, El, tau)
    h = (slice(0, 7), slice(7, 16))
    parts = [flda_estep_pass(lb, kap, terms[:, s], counts[:, s], dm, eta, El,
                             tau[:, s].contiguous()) for s in h]
    torch.testing.assert_close(parts[0][0] + parts[1][0], whole[0], rtol=1e-13, atol=0.0)
    assert torch.equal(torch.cat([parts[0][1], parts[1][1]], dim=1), whole[1])
    assert torch.equal(whole[0][-1], torch.zeros_like(whole[0][-1]))
    assert torch.equal(whole[1][-1], tau[-1])
    for a, b in zip(whole, flda_estep_pass_ref(lb, kap, terms, counts, dm, eta, El, tau)):
        assert torch.equal(a, b)


def test_ctpf_pass_over_split_slots_sums_to_the_whole_pass():
    """The CTPF pass mode's plain version on the halves of every document's
    token slots and reader slots sums to the pass on the whole; a masked
    document gets zeros."""
    from topicmodelsvb_jl_torch.kernels.ctpf_estep import ctpf_estep_pass, ctpf_estep_pass_ref

    ea, eh, terms, counts, readers, ratings, dm, idb, idv, ihv, gi, _, za, _ = \
        _ctpf_split_args(5)
    whole = ctpf_estep_pass(ea, eh, terms, counts, readers, ratings, dm, idb, idv, ihv, gi, za)
    parts = [ctpf_estep_pass(ea, eh, terms[:, st], counts[:, st], readers[:, sr],
                             ratings[:, sr], dm, idb, idv, ihv, gi, za)
             for st, sr in ((slice(0, 8), slice(0, 3)), (slice(8, 16), slice(3, 6)))]
    for i in range(2):
        torch.testing.assert_close(parts[0][i] + parts[1][i], whole[i], rtol=1e-13, atol=0.0)
        assert torch.equal(whole[i][-1], torch.zeros_like(whole[i][-1]))
    assert torch.equal(whole[1][0], torch.zeros_like(whole[1][0]))   # no reader: no zayin mass
    ref = ctpf_estep_pass_ref(ea, eh, terms, counts, readers, ratings, dm, idb, idv, ihv, gi, za)
    assert all(torch.equal(a, b) for a, b in zip(whole, ref))


def test_flda_split_fixpoint_f64_channel_equals_the_fused_plain_version():
    """fLDA's split fixpoint takes the same float64 psi on its tiles:
    driven alone on a float32 state it gives the fused plain version's
    bits, which are not the float32 channel's."""
    from topicmodelsvb_jl_torch.kernels.flda_estep import flda_estep_ref, flda_split_fixpoint

    args = tuple(a.float() if a.is_floating_point() else a for a in _flda_split_args(4))
    a = flda_split_fixpoint(*args, viter=7, vtol=1e-3, elogtheta_f64=True)
    b = flda_estep_ref(*args, viter=7, vtol=1e-3, elogtheta_f64=True)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert not torch.equal(a[1], flda_split_fixpoint(*args, viter=7, vtol=1e-3)[1])
