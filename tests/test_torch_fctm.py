"""The port's fCTM slice against the JAX package, on CPU.

As ``test_torch_ctm.py``: both packages train from the same JAX init,
injected through ``convert.py``, and agree in f64 to 1e-8 relative per
iteration and per state field, tau per bucketed segment included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import topicmodelsvb_jl_tpu as tm
from topicmodelsvb_jl_tpu.datasets import synth_packed_nsf_scale as jax_synth
from topicmodelsvb_jl_tpu.models import fctm as jax_fctm
from topicmodelsvb_jl_tpu.parallel.mesh import make_mesh
from topicmodelsvb_jl_tpu.utils.config import RuntimeConfig as JaxRuntimeConfig
import topicmodelsvb_jl_torch as tt
from topicmodelsvb_jl_torch.api import TopicModelError
from topicmodelsvb_jl_torch.convert import (
    FCTM_FIELDS, fctm_state_from_numpy, fctm_state_to_numpy,
)
from topicmodelsvb_jl_torch.models import fctm as torch_fctm
from topicmodelsvb_jl_torch.validate import check_model, state_violations

CORPUS = dict(M=200, V=120, mean_terms=15, seed=2, chunk_docs=16)
CHUNK = 16
FIELDS = ("eta", "mu", "sigma", "invsigma", "kappa", "beta", "lam", "lam_old", "vsq",
          "logzeta", "tau", "tau_old")


def _models(K, seed=3, identify=False):
    jm = tm.fCTM(jax_synth(**CORPUS), K,
                 runtime=JaxRuntimeConfig(chunk_docs=CHUNK, dtype="float64"),
                 mesh=make_mesh(n_devices=1), seed=seed, identify=identify)
    pm = tt.fCTM(tt.synth_packed_nsf_scale(**CORPUS), K,
                 tt.RuntimeConfig(chunk_docs=CHUNK, dtype="float64"),
                 device="cpu", seed=seed, identify=identify)
    pm.state = fctm_state_from_numpy(jm.state._asdict(), "cpu", torch.float64)
    return jm, pm


def _assert_fields(jax_fields, torch_fields, names, where):
    for f in names:
        np.testing.assert_allclose(np.asarray(torch_fields[f]), np.asarray(jax_fields[f]),
                                   rtol=1e-8, atol=1e-12, err_msg=f"{f} at {where}")


@pytest.mark.parametrize("identify", [False, True])
def test_step_and_elbo_match_jax_every_iteration(identify):
    """make_step/make_elbo on the bucketed corpus, state by state."""
    K, iters = 4, 3
    jm, pm = _models(K, identify=identify)
    p = jm.packed
    assert len(p.segments) >= 2 and pm.state.tau.shape == (p.M_pad, p.L)
    kw = dict(viter=10, vtol=1.0 / K**2, niter=1000, ntol=1.0 / K**2, chunk_docs=CHUNK,
              identify=identify)
    jstep = jax.jit(jax_fctm.make_step(p, K, axis_name=None, **kw))
    jelbo = jax.jit(jax_fctm.make_elbo(p, K, chunk_docs=CHUNK))
    tstep = torch_fctm.make_step(pm.packed, K, device="cpu", **kw)
    telbo = torch_fctm.make_elbo(pm.packed, K, chunk_docs=CHUNK)
    jdata = tuple(tuple(jnp.asarray(getattr(s, f)) for s in p.segments)
                  for f in ("terms", "counts", "doc_mask"))
    tdata = pm._data_arrays()
    js, ts = jm.state, pm.state
    for it in range(1, iters + 1):
        js = jstep(js, *jdata, jnp.asarray(float(p.M)))
        ts = tstep(ts, *tdata, float(pm.M))
        _assert_fields(js._asdict(), fctm_state_to_numpy(ts), FIELDS, f"iteration {it}")
        je, te = float(jnp.sum(jelbo(js, *jdata))), float(torch.sum(telbo(ts, *tdata)))
        assert abs(te - je) <= 1e-8 * abs(je), (it, te, je)
    assert float(ts.eta) == 0.5     # update_eta! is not run (fCTM.jl:267)


def test_train_matches_jax():
    """The slice through the user API: fCTM(...).train() and its accessors."""
    K, iters = 3, 3
    jm, pm = _models(K, seed=7)
    jm.train(iter=iters, checkelbo=1, niter=40, printelbo=False)
    pm.train(iter=iters, checkelbo=1, niter=40, printelbo=False)
    np.testing.assert_allclose([r.elbo for r in pm.trainer.trace],
                               [r.elbo for r in jm.trainer.trace], rtol=1e-8)
    names = ("mu", "sigma", "kappa", "beta", "lam", "vsq", "logzeta")
    _assert_fields({f: getattr(jm, f) for f in names}, {f: getattr(pm, f) for f in names},
                   names, "the end")
    assert pm.eta == jm.eta == 0.5 and len(pm.tau) == pm.M
    for d in (0, 1, pm.M - 1):
        np.testing.assert_allclose(pm.tau[d], jm.tau[d], rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(pm.topicdist([1, 2]), jm.topicdist([1, 2]), rtol=1e-8)
    assert all(r.delta_elbo > 0 for r in pm.trainer.trace[1:])


def test_check_model_rejects_bad_state():
    _, pm = _models(3)
    check_model(pm)
    pm.state.tau = pm.state.tau.clone()
    pm.state.tau[0, 0] = 1.5
    pm.state.vsq = -pm.state.vsq
    assert state_violations(pm) == ["vsq must be positive", "tau must be in [0, 1]"]
    with pytest.raises(TopicModelError, match="vsq must be positive; tau must be in"):
        pm.train(iter=1)
    _, pm = _models(3)
    pm.state.sigma = torch.tensor([[1.0, 2.0, 0.0], [2.0, 1.0, 0.0], [0.0, 0.0, 1.0]],
                                  dtype=pm.dtype)
    assert state_violations(pm) == ["sigma must be positive definite"]


def test_convert_round_trip():
    jm, pm = _models(3)
    arrays = fctm_state_to_numpy(pm.state)
    assert set(arrays) == set(FCTM_FIELDS) and len(FCTM_FIELDS) == 15
    for f in FCTM_FIELDS:
        np.testing.assert_array_equal(arrays[f], np.asarray(getattr(jm.state, f)))
    back = fctm_state_from_numpy(arrays, "cpu", torch.float32)
    assert back.tau.dtype == torch.float32 and back.eta.shape == ()


def test_same_seed_is_bitwise_deterministic():
    run = lambda seed: tt.fCTM(tt.synth_packed_nsf_scale(**CORPUS), 4,
                               tt.RuntimeConfig(chunk_docs=CHUNK), device="cpu",
                               seed=seed).train(iter=2, checkelbo=float("inf"),
                                                printelbo=False)
    a, b = run(9), run(9)
    for f in ("mu", "sigma", "beta", "kappa", "lam", "vsq", "logzeta"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    assert all(np.array_equal(x, y) for x, y in zip(a.tau, b.tau))


def test_default_chunk_is_2048():
    p = tt.synth_packed_nsf_scale(M=3000, V=100, mean_terms=8, seed=2)
    m = tt.fCTM(p, 3, device="cpu")
    assert m.chunk_docs == 2048 and m.runtime.chunk_docs == 2048
