"""The port's fLDA slice against the JAX package, on CPU.

Both packages train from the same JAX init, injected into the port
through ``convert.py``.  In f64 the trajectories agree to 1e-8 relative
per iteration; what separates them is the E-step's ψ, the kernels'
shift-by-8 series (~2.5e-10 truncation) in the port.  The kernel module's
plain version is held to the Pallas kernel in interpret mode in f32 at
the JAX package's own Pallas-vs-XLA tolerance (rtol 5e-3, atol 1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.special import digamma

import topicmodelsvb_jl_tpu as tm
from topicmodelsvb_jl_tpu.datasets import synth_packed_nsf_scale as jax_synth
from topicmodelsvb_jl_tpu.kernels.flda_estep import flda_estep as jax_flda_estep
from topicmodelsvb_jl_tpu.models import flda as jax_flda
from topicmodelsvb_jl_tpu.parallel.mesh import make_mesh
from topicmodelsvb_jl_tpu.utils.config import RuntimeConfig as JaxRuntimeConfig
import topicmodelsvb_jl_torch as tt
from topicmodelsvb_jl_torch.api import TopicModelError
from topicmodelsvb_jl_torch.convert import (
    FLDA_FIELDS, flda_state_from_numpy, flda_state_to_numpy,
)
from topicmodelsvb_jl_torch.kernels.flda_estep import flda_estep, flda_estep_ref
from topicmodelsvb_jl_torch.models import flda as torch_flda
from topicmodelsvb_jl_torch.utils.numerics import EPSILON
from topicmodelsvb_jl_torch.validate import check_model, state_violations

CORPUS = dict(M=300, V=200, mean_terms=20, seed=1, chunk_docs=16)
CHUNK = 16
KP = 128


def _models(K, seed=3):
    jm = tm.fLDA(jax_synth(**CORPUS), K,
                 runtime=JaxRuntimeConfig(chunk_docs=CHUNK, dtype="float64"),
                 mesh=make_mesh(n_devices=1), seed=seed)
    pm = tt.fLDA(tt.synth_packed_nsf_scale(**CORPUS), K,
                 tt.RuntimeConfig(chunk_docs=CHUNK, dtype="float64"),
                 device="cpu", seed=seed)
    pm.state = flda_state_from_numpy(jm.state._asdict(), "cpu", torch.float64)
    return jm, pm


def _assert_fields(jax_fields, torch_fields, names, where):
    for f in names:
        np.testing.assert_allclose(np.asarray(torch_fields[f]), np.asarray(jax_fields[f]),
                                   rtol=1e-8, atol=1e-12, err_msg=f"{f} at {where}")


def test_packing_byte_identical():
    """The model's own bucketing of the LDA fixture's corpus."""
    jm, pm = _models(3)
    a, b = jm.packed, pm.packed
    assert len(a.segments) >= 2 and len(a.segments) == len(b.segments)
    for f in ("terms", "counts", "doc_mask", "N", "C", "order", "inv_order"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), f
    for sa, sb in zip(a.segments, b.segments):
        assert (sa.L, sa.n_local, sa.loc_start) == (sb.L, sb.n_local, sb.loc_start)
        for f in ("terms", "counts", "doc_mask"):
            assert getattr(sa, f).tobytes() == getattr(sb, f).tobytes(), f
    assert pm.chunk_docs == jm.chunk_docs and pm.state.tau.shape == (a.M_pad, a.L)


FIELDS = ("eta", "alpha", "kappa", "beta", "gamma", "Elogtheta", "Elogtheta_old",
          "tau", "tau_old")


def test_step_and_elbo_match_jax_every_iteration():
    """make_step/make_elbo on the bucketed corpus, state by state."""
    K, iters = 5, 3
    jm, pm = _models(K)
    p = jm.packed
    kw = dict(viter=10, vtol=1.0 / K**2, niter=1000, ntol=1.0 / K**2,
              chunk_docs=CHUNK)
    jstep = jax.jit(jax_flda.make_step(p, K, axis_name=None, use_pallas=False, **kw))
    jelbo = jax.jit(jax_flda.make_elbo(p, K, chunk_docs=CHUNK))
    tstep = torch_flda.make_step(pm.packed, K, device="cpu", **kw)
    telbo = torch_flda.make_elbo(pm.packed, K, chunk_docs=CHUNK)
    jdata = tuple(tuple(jnp.asarray(getattr(s, f)) for s in p.segments)
                  for f in ("terms", "counts", "doc_mask"))
    tdata = pm._data_arrays()
    M_t, C_t = (torch.tensor(x, dtype=torch.float64) for x in (float(p.M), float(p.C.sum())))
    js, ts = jm.state, pm.state
    for it in range(1, iters + 1):
        js = jstep(js, *jdata, jnp.asarray(float(p.M)), jnp.asarray(float(p.C.sum())))
        ts = tstep(ts, *tdata, M_t, C_t)
        _assert_fields(js._asdict(), flda_state_to_numpy(ts), FIELDS, f"iteration {it}")
        je, te = float(jnp.sum(jelbo(js, *jdata))), float(torch.sum(telbo(ts, *tdata)))
        assert abs(te - je) <= 1e-8 * abs(je), (it, te, je)


def test_train_matches_jax():
    """The slice through the user API: fLDA(...).train() and accessors."""
    K, iters = 4, 3
    jm, pm = _models(K, seed=7)
    jm.train(iter=iters, checkelbo=1, printelbo=False)
    pm.train(iter=iters, checkelbo=1, printelbo=False)
    np.testing.assert_allclose([r.elbo for r in pm.trainer.trace],
                               [r.elbo for r in jm.trainer.trace], rtol=1e-8)
    names = ("alpha", "kappa", "beta", "gamma", "Elogtheta")
    _assert_fields({f: getattr(jm, f) for f in names},
                   {f: getattr(pm, f) for f in names}, names, "the end")
    assert pm.eta == pytest.approx(jm.eta, rel=1e-8)
    assert len(pm.tau) == pm.M
    for d in (0, 1, pm.M - 1):
        np.testing.assert_allclose(pm.tau[d], jm.tau[d], rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(pm.topicdist([1, 2, 3]), jm.topicdist([1, 2, 3]), rtol=1e-8)
    np.testing.assert_array_equal(pm.topics[:, :5], jm.topics[:, :5])


def _chunk_inputs(K, B=16, L=24, V=40, seed=3):
    """One chunk of documents with a warm state; the last 3 are padding."""
    r = np.random.default_rng(seed)
    beta = r.dirichlet(np.ones(V), size=K)
    kappa = r.dirichlet(np.ones(V))
    terms = r.integers(0, V, size=(B, L)).astype(np.int32)
    counts = (1 + r.poisson(0.4, size=(B, L))).astype(np.float32)
    valid = np.arange(L)[None, :] < r.integers(3, L, size=B)[:, None]
    counts *= valid
    terms *= valid
    doc_mask = np.ones(B, np.float32)
    doc_mask[-3:] = 0.0
    counts[-3:] = 0.0
    alpha = r.uniform(0.2, 1.5, K)
    gamma = alpha + r.uniform(0.1, 5.0, size=(B, K))
    El = digamma(gamma) - digamma(gamma.sum(-1, keepdims=True))
    f = lambda a: np.asarray(a, np.float32)
    return dict(logbetaT=f(np.log(beta.T + EPSILON)), kappa=f(kappa), terms=terms,
                counts=counts, doc_mask=doc_mask, alpha=f(alpha), eta=np.float32(0.6),
                gamma=f(gamma), El=f(El), El_old=f(El + r.normal(0, 0.05, size=(B, K))),
                tau=f(r.uniform(0.1, 0.9, size=(B, L))),
                tau_old=f(r.uniform(0.1, 0.9, size=(B, L))))


def _torch_args(x):
    return tuple(torch.tensor(x[k]) for k in (
        "logbetaT", "kappa", "terms", "counts", "doc_mask", "alpha", "eta",
        "gamma", "El", "El_old", "tau", "tau_old"))


@pytest.mark.parametrize("K", [7, 16])
def test_flda_estep_ref_matches_pallas(K):
    """Padded to Kp = 128 by the JAX package's conventions (models/flda.py:
    183-196): log-beta and alpha pads 0, Elogtheta pads −1e30."""
    x = _chunk_inputs(K)
    vtol = 1.0 / K**2
    padk = lambda a, v=0.0: jnp.pad(jnp.asarray(a), ((0, 0), (0, KP - K)),
                                    constant_values=v)
    want = jax_flda_estep(
        padk(x["logbetaT"])[jnp.asarray(x["terms"])], jnp.asarray(x["kappa"][x["terms"]]),
        jnp.asarray(x["counts"]), jnp.asarray(x["doc_mask"]),
        jnp.pad(jnp.asarray(x["alpha"]), (0, KP - K)), jnp.asarray(x["eta"]),
        padk(x["gamma"]), padk(x["El"], -1e30), padk(x["El_old"], -1e30),
        jnp.asarray(x["tau"]), jnp.asarray(x["tau_old"]),
        viter=6, vtol=vtol, n_topics=K, interpret=True)
    got = flda_estep_ref(*_torch_args(x), viter=6, vtol=vtol)
    w = got[5].numpy()
    pairs = [("gamma", got[0], np.asarray(want[0])[:, :K]),
             ("El", got[1], np.asarray(want[1])[:, :K]),
             ("El_old", got[2], np.asarray(want[2])[:, :K]),
             ("tau", got[3], want[3]), ("tau_old", got[4], want[4]),
             ("w_beta", w[..., :K], np.asarray(want[5])[..., :K]),
             ("w_kappa", w[..., K], want[6])]
    for name, a, b in pairs:
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=5e-3, atol=1e-5,
                                   err_msg=f"{name} diverged")


def test_flda_estep_wrapper_takes_plain_version_on_cpu():
    x = _chunk_inputs(6, seed=4)
    before = flda_estep.launches
    got = flda_estep(*_torch_args(x), viter=4, vtol=1e-3)
    want = flda_estep_ref(*_torch_args(x), viter=4, vtol=1e-3)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert flda_estep.launches == before
    # padded documents keep their state, tau included, and get zero rows
    for a, k in zip(got[:5], ("gamma", "El", "El_old", "tau", "tau_old")):
        np.testing.assert_array_equal(a.numpy()[-3:], x[k][-3:])
    assert torch.all(got[5][-3:] == 0) and got[5].shape == (16, 24, 7)
    with pytest.raises(ValueError, match="no kernel"):
        flda_estep(*(a.to("meta") for a in _torch_args(x)), viter=2, vtol=1e-3)


def test_check_model_rejects_broken_eta_kappa_tau():
    pm = tt.fLDA(tt.synth_packed_nsf_scale(**CORPUS), 3,
                 tt.RuntimeConfig(chunk_docs=CHUNK), device="cpu")
    check_model(pm)
    pm.state.eta = torch.tensor(1.5)
    pm.state.kappa = pm.state.kappa * 2.0
    pm.state.tau[0, 0] = -0.1
    assert state_violations(pm) == ["eta must be in [0, 1]",
                                    "kappa must be a stochastic matrix",
                                    "tau must be in [0, 1]"]
    with pytest.raises(TopicModelError, match="eta must be in"):
        pm.train(iter=1)


def test_convert_round_trip():
    jm, pm = _models(3)
    arrays = flda_state_to_numpy(pm.state)
    assert set(arrays) == set(FLDA_FIELDS) and len(FLDA_FIELDS) == 12
    for f in FLDA_FIELDS:
        np.testing.assert_array_equal(arrays[f], np.asarray(getattr(jm.state, f)))
    back = flda_state_from_numpy(arrays, "cpu", torch.float32)
    assert back.tau.dtype == torch.float32 and back.eta.shape == ()


def test_same_seed_is_bitwise_deterministic():
    run = lambda seed: tt.fLDA(tt.synth_packed_nsf_scale(**CORPUS), 4,
                               tt.RuntimeConfig(chunk_docs=CHUNK), device="cpu",
                               seed=seed).train(iter=2, checkelbo=float("inf"),
                                                printelbo=False)
    a, b = run(9), run(9)
    for f in ("alpha", "beta", "kappa", "gamma", "eta"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    assert a.state.eta.dtype == torch.float32
