"""The port's CTM slice against the JAX package, on CPU.

Both packages train from the same JAX init, injected into the port
through ``convert.py``.  In f64 the step and the bound agree to 1e-8
relative per iteration and per state field: both run the same Newtons and
the same CG to 1e-13, so what separates them is summation order in the
matrix products and reductions (and the bound's token terms, which the
port takes through ``lda_elbo_tok``'s algebra, as the JAX package's
kernel path does).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import topicmodelsvb_jl_tpu as tm
from topicmodelsvb_jl_tpu.datasets import synth_packed_nsf_scale as jax_synth
from topicmodelsvb_jl_tpu.models import ctm as jax_ctm
from topicmodelsvb_jl_tpu.ops import newton as jax_newton
from topicmodelsvb_jl_tpu.parallel.mesh import make_mesh
from topicmodelsvb_jl_tpu.utils.config import RuntimeConfig as JaxRuntimeConfig
import topicmodelsvb_jl_torch as tt
from topicmodelsvb_jl_torch.api import TopicModelError
from topicmodelsvb_jl_torch.convert import CTM_FIELDS, ctm_state_from_numpy, ctm_state_to_numpy
from topicmodelsvb_jl_torch.models import ctm as torch_ctm
from topicmodelsvb_jl_torch.ops import newton as torch_newton
from topicmodelsvb_jl_torch.validate import check_model, state_violations

CORPUS = dict(M=200, V=120, mean_terms=15, seed=1, chunk_docs=16)
CHUNK = 16
FIELDS = ("mu", "sigma", "invsigma", "beta", "lam", "lam_old", "vsq", "logzeta")


def _models(K, seed=3, identify=False, cls=(tm.CTM, tt.CTM), corpus=CORPUS):
    jm = cls[0](jax_synth(**corpus), K,
                runtime=JaxRuntimeConfig(chunk_docs=CHUNK, dtype="float64"),
                mesh=make_mesh(n_devices=1), seed=seed, identify=identify)
    pm = cls[1](tt.synth_packed_nsf_scale(**corpus), K,
                tt.RuntimeConfig(chunk_docs=CHUNK, dtype="float64"),
                device="cpu", seed=seed, identify=identify)
    return jm, pm


def _inject(jm, pm, from_numpy=ctm_state_from_numpy):
    pm.state = from_numpy(jm.state._asdict(), "cpu", torch.float64)


def _assert_fields(jax_fields, torch_fields, names, where, rtol=1e-8):
    for f in names:
        np.testing.assert_allclose(np.asarray(torch_fields[f]), np.asarray(jax_fields[f]),
                                   rtol=rtol, atol=1e-12, err_msg=f"{f} at {where}")


@pytest.mark.parametrize("identify", [False, True])
def test_step_and_elbo_match_jax_every_iteration(identify):
    """make_step/make_elbo on the bucketed corpus, state by state."""
    K, iters = 4, 3
    jm, pm = _models(K, identify=identify)
    _inject(jm, pm)
    p = jm.packed
    assert len(p.segments) >= 2
    kw = dict(viter=10, vtol=1.0 / K**2, niter=1000, ntol=1.0 / K**2, chunk_docs=CHUNK,
              identify=identify)
    jstep = jax.jit(jax_ctm.make_step(p, K, axis_name=None, **kw))
    jelbo = jax.jit(jax_ctm.make_elbo(p, K, chunk_docs=CHUNK, use_pallas=False))
    tstep = torch_ctm.make_step(pm.packed, K, device="cpu", **kw)
    telbo = torch_ctm.make_elbo(pm.packed, K, chunk_docs=CHUNK)
    jdata = tuple(tuple(jnp.asarray(getattr(s, f)) for s in p.segments)
                  for f in ("terms", "counts", "doc_mask"))
    tdata = pm._data_arrays()
    js, ts = jm.state, pm.state
    for it in range(1, iters + 1):
        js = jstep(js, *jdata, jnp.asarray(float(p.M)))
        ts = tstep(ts, *tdata, float(pm.M))
        _assert_fields(js._asdict(), ctm_state_to_numpy(ts), FIELDS, f"iteration {it}")
        je, te = float(jnp.sum(jelbo(js, *jdata))), float(torch.sum(telbo(ts, *tdata)))
        assert abs(te - je) <= 1e-8 * abs(je), (it, te, je)
    if identify:
        assert abs(float(ts.mu.sum())) < 1e-10
        one = torch.ones(K, dtype=torch.float64) / K**0.5
        assert float(one @ ts.sigma @ one) == pytest.approx(1.0, rel=1e-10)


def test_train_matches_jax():
    """The slice through the user API: CTM(...).train() and its accessors."""
    K, iters = 3, 3
    jm, pm = _models(K, seed=7)
    _inject(jm, pm)
    jm.train(iter=iters, checkelbo=1, niter=40, printelbo=False)
    pm.train(iter=iters, checkelbo=1, niter=40, printelbo=False)
    np.testing.assert_allclose([r.elbo for r in pm.trainer.trace],
                               [r.elbo for r in jm.trainer.trace], rtol=1e-8)
    names = ("mu", "sigma", "invsigma", "beta", "lam", "vsq", "logzeta")
    _assert_fields({f: getattr(jm, f) for f in names}, {f: getattr(pm, f) for f in names},
                   names, "the end")
    np.testing.assert_array_equal(pm.lambda_, pm.lam)
    np.testing.assert_allclose(pm.topicdist([1, 2, 3]), jm.topicdist([1, 2, 3]), rtol=1e-8)
    np.testing.assert_array_equal(pm.topics[:, :5], jm.topics[:, :5])
    assert all(r.delta_elbo > 0 for r in pm.trainer.trace[1:])


def expo_of(C, lam):
    return C.numpy()[:, None] * np.exp(lam.numpy())


@pytest.mark.parametrize("which", ["lambda", "vsq", "cg"])
def test_host_check_every_n_is_bitwise_equal(which):
    """Testing ``any(active)`` every 8th iteration instead of every one
    changes no bit: lanes that stopped are frozen by ``where``."""
    r = np.random.default_rng(4)
    B, K = 24, 6
    a = r.normal(size=(K, K))
    invsigma = torch.tensor(a @ a.T / K + np.eye(K))
    lam = torch.tensor(r.normal(0, 0.5, size=(B, K)))
    vsq = torch.tensor(r.uniform(0.3, 2.0, size=(B, K)))
    C = torch.tensor(r.integers(5, 60, size=B).astype(np.float64))
    logzeta = torch.logsumexp(lam + 0.5 * vsq, -1)
    pc = C[:, None] * torch.softmax(torch.tensor(r.normal(size=(B, K))), -1)
    mu = torch.tensor(r.normal(0, 0.3, size=K))
    active = torch.tensor(r.random(B) < 0.8)

    def run(n):
        if which == "lambda":
            return torch_newton.ctm_lambda_newton(lam, vsq, logzeta, pc, C, mu, invsigma,
                                                  active, 1000, 1e-6, check_every=n)
        if which == "vsq":
            return torch_newton.ctm_vsq_newton(lam, vsq, logzeta, C, torch.diagonal(invsigma),
                                               active, 1000, 1e-6, check_every=n)
        expo = torch.tensor(expo_of(C, lam))
        return torch_newton.spd_cg_solve(invsigma, expo, pc - expo,
                                         1.0 / (torch.diagonal(invsigma) + expo), active,
                                         K + 8, 1e-13, check_every=n)

    one, eight = run(1), run(8)
    start = {"lambda": lam, "vsq": vsq, "cg": torch.zeros_like(lam)}[which]
    assert torch.equal(one, eight) and not torch.equal(one, start)
    for n in (1, 8):      # and both agree with the JAX package
        got = run(n).numpy()
        if which == "lambda":
            want = jax_newton.ctm_lambda_newton(*(jnp.asarray(x.numpy()) for x in (
                lam, vsq, logzeta, pc, C, mu, invsigma, active)), 1000, 1e-6)
        elif which == "vsq":
            want = jax_newton.ctm_vsq_newton(*(jnp.asarray(x.numpy()) for x in (
                lam, vsq, logzeta, C, torch.diagonal(invsigma), active)), 1000, 1e-6)
        else:
            jinv, jexpo = jnp.asarray(invsigma.numpy()), jnp.asarray(expo_of(C, lam))
            want = jax_newton.spd_cg_solve(
                lambda x: x @ jinv + jexpo * x, jnp.asarray(pc.numpy()) - jexpo,
                1.0 / (jnp.diagonal(jinv) + jexpo), jnp.asarray(active.numpy()), K + 8, 1e-13)
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-10, atol=1e-12)


def test_check_model_rejects_bad_sigma_and_vsq():
    _, pm = _models(3)
    check_model(pm)
    pm.state.vsq = pm.state.vsq.clone()
    pm.state.vsq[0, 1] = 0.0
    assert state_violations(pm) == ["vsq must be positive"]
    with pytest.raises(TopicModelError, match="vsq must be positive"):
        pm.train(iter=1)
    _, pm = _models(3)
    pm.state.sigma = torch.diag(torch.tensor([1.0, -0.5, 2.0], dtype=pm.dtype))
    assert state_violations(pm) == ["sigma must be positive definite"]
    pm.state.mu = torch.tensor([0.0, float("nan"), 0.0], dtype=pm.dtype)
    assert state_violations(pm) == ["mu must be finite"]


def test_convert_round_trip():
    jm, pm = _models(3)
    _inject(jm, pm)
    arrays = ctm_state_to_numpy(pm.state)
    assert set(arrays) == set(CTM_FIELDS) and len(CTM_FIELDS) == 10
    for f in CTM_FIELDS:
        np.testing.assert_array_equal(arrays[f], np.asarray(getattr(jm.state, f)))
    back = ctm_state_from_numpy(arrays, "cpu", torch.float32)
    assert back.sigma.dtype == torch.float32 and back.logzeta.shape == (jm.packed.M_pad,)


def test_same_seed_is_bitwise_deterministic():
    run = lambda seed: tt.CTM(tt.synth_packed_nsf_scale(**CORPUS), 4,
                              tt.RuntimeConfig(chunk_docs=CHUNK), device="cpu",
                              seed=seed).train(iter=2, checkelbo=float("inf"),
                                               printelbo=False)
    a, b = run(9), run(9)
    for f in ("mu", "sigma", "beta", "lam", "vsq", "logzeta"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    assert a.state.beta.dtype == torch.float32


def test_default_chunk_is_2048():
    """Without a RuntimeConfig, CTM takes 2048-document chunks as the JAX
    package does (api.py:52-55); LDA keeps 1024."""
    p = tt.synth_packed_nsf_scale(M=5000, V=100, mean_terms=8, seed=2)
    assert tt.CTM(p, 3, device="cpu").chunk_docs == 2048
    assert tt.LDA(p, 3, device="cpu").chunk_docs == 1024
    assert tm.CTM(jax_synth(M=5000, V=100, mean_terms=8, seed=2), 3,
                  mesh=make_mesh(n_devices=1)).chunk_docs == 2048
