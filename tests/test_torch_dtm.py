"""The port's dynamic topic model against the JAX package's, on CPU in f64.

Both packages take the same numpy inputs, and the port's model starts from
the JAX init, injected through ``convert.py`` (``betahat`` is drawn by
``jax.random.normal``).  The smoothers agree to 1e-12, the E-step chunk to
1e-10, the CG objective and its autograd gradient to 1e-10 of
``jax.grad``'s, the M-step (batched alpha Newtons and the CG) to 1e-8,
and a full step and the bound over 3 iterations to 1e-8 per iteration,
the tolerance of the JAX package's own oracle tests (tests/test_dtm.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import topicmodelsvb_jl_tpu as tm
from topicmodelsvb_jl_tpu.models import dtm as jax_dtm
from topicmodelsvb_jl_tpu.ops import newton as jax_newton
from topicmodelsvb_jl_tpu.parallel.mesh import make_mesh
from topicmodelsvb_jl_tpu.utils.config import RuntimeConfig as JaxRuntimeConfig
import topicmodelsvb_jl_torch as tt
from topicmodelsvb_jl_torch import convert
from topicmodelsvb_jl_torch.engine import HostReads
from topicmodelsvb_jl_torch.kernels.scatter_rows import build_plan
from topicmodelsvb_jl_torch.models import dtm as torch_dtm
from topicmodelsvb_jl_torch.ops import newton as torch_newton
from topicmodelsvb_jl_torch.ops.segment import count_scatter_into
from topicmodelsvb_jl_torch.validate import state_violations

CORPUS = dict(M=40, V=30, K=3, seed=6, n_slices=3, drift=0.3, mean_terms=18, mean_tokens=30)
K, CHUNK = 3, 8


def _models(corpus=CORPUS, seed=4, **kw):
    """The JAX model and the port's on the same corpus, the port's state
    the JAX init."""
    jm = tm.DTM(tm.synth_corpus(**corpus), K, delta=1.0,
                runtime=JaxRuntimeConfig(chunk_docs=CHUNK, dtype="float64", pad_multiple=8),
                seed=seed, mesh=make_mesh(n_devices=1), **kw)
    pm = tt.DTM(tt.synth_corpus(**corpus), K, delta=1.0,
                runtime=tt.RuntimeConfig(chunk_docs=CHUNK, dtype="float64", pad_multiple=8),
                seed=seed, device="cpu", **kw)
    pm.state = convert.dtm_state_from_numpy(jm.state._asdict(), "cpu", torch.float64)
    return jm, pm


def _t(a):
    return torch.as_tensor(np.array(a))


def _close(got, want, rtol, what, atol=1e-13):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=what)


def test_slice_assignment_matches_jax_and_the_reference_loop():
    jm, pm = _models()
    assert (pm.T, pm.M, pm.packed.M_pad, pm.chunk_docs) == (jm.T, jm.M, jm.packed.M_pad,
                                                           jm.chunk_docs)
    np.testing.assert_array_equal(pm.slice_id, jm.slice_id)
    assert [sorted(map(int, s)) for s in pm.S] == [sorted(map(int, s)) for s in jm.S]
    np.testing.assert_array_equal(pm.packed.terms, jm.packed.terms)
    stamps = np.array([d.stamp for d in pm.corp.docs])
    t0 = stamps.min()
    S_ref, t = [[] for _ in range(pm.T)], 1
    for d in np.argsort(stamps, kind="stable"):   # DTM.jl:58-63
        while stamps[d] > t0 + t * 1.0:
            t += 1
        S_ref[t - 1].append(d + 1)
    assert [sorted(map(int, s)) for s in pm.S] == [sorted(s) for s in S_ref]
    for st, delta, m_pad in (([0.0, 0.5, 1.0, 2.5, 2.5], 1.0, None), ([3.0, 3.0], 0.7, 8),
                             ([5.0, -1.0, 2.2, 9.9], 2.5, 6)):
        T, sid = tt.slices_from_stamps(st, delta, m_pad)
        Tj, sidj = tm.slices_from_stamps(st, delta, m_pad)
        assert T == Tj and sid.dtype == sidj.dtype == np.int32
        np.testing.assert_array_equal(sid, sidj)
    with pytest.raises(ValueError, match="finite stamp"):
        tt.slices_from_stamps([1.0, float("nan")], 1.0)


def test_smoothers_match_jax():
    T, Kk, V = 5, 2, 4
    vf, vb = torch_dtm.variance_smoother(T, Kk, V, torch.float64)
    jvf, jvb = jax_dtm.variance_smoother(T, Kk, V, jnp.float64)
    _close(vf, jvf, 1e-12, "v_filt")
    _close(vb, jvb, 1e-12, "vbeta")
    bh = np.random.default_rng(0).standard_normal((T, Kk, V))
    _close(torch_dtm.mean_smoother(_t(bh), vf), jax_dtm.mean_smoother(jnp.asarray(bh), jvf),
           1e-12, "mbeta")


def test_estep_chunk_matches_jax():
    """One chunk: the fixpoint's state, A [T·V, K] scattered along the
    chunk's token plan, and the per-slice sums along its slice plan."""
    jm, pm = _models()
    js, T, V = jm.state, jm.T, jm.V
    x = np.asarray(js.mbeta) + 0.5 * np.asarray(js.vbeta)
    maxl = x.max(axis=(1, 2))
    rowsum = np.exp(x - maxl[:, None, None]).sum(axis=2)
    mflat = np.asarray(js.mbeta).transpose(0, 2, 1).reshape(T * V, K)
    p, rows = jm.packed, slice(CHUNK, 2 * CHUNK)
    sid, terms, counts, dm = (pm.slice_id[rows], p.terms[rows], p.counts[rows],
                              p.doc_mask[rows])
    args = (js.gamma[rows], js.Elogtheta[rows], js.lzeta[rows])
    want = jax_dtm._estep_chunk(jnp.asarray(mflat), js.alpha, jnp.asarray(rowsum),
                                jnp.asarray(maxl), jnp.asarray(sid), jnp.asarray(terms),
                                jnp.asarray(counts), jnp.asarray(dm), *args, 5, 1.0 / K**2, V)
    flat = sid.astype(np.int64)[:, None] * V + terms
    g, el, lz, w, pc = torch_dtm._estep_chunk(
        _t(mflat), pm.state.alpha, _t(rowsum), _t(maxl), _t(sid).long(), _t(flat), _t(counts),
        _t(dm), *(_t(a) for a in args), 5, 1.0 / K**2)
    A = count_scatter_into(torch.zeros(T * V, K, dtype=torch.float64), w.reshape(-1, K),
                           build_plan(flat, counts > 0))
    per = count_scatter_into(torch.zeros(T, 2 * K + 1, dtype=torch.float64),
                             torch.cat([torch.exp(-lz)[:, None] * pc * _t(dm)[:, None],
                                        el * _t(dm)[:, None], _t(dm)[:, None]], 1),
                             build_plan(sid, dm > 0))
    for name, a, b in zip(("gamma", "El", "lzeta", "A", "wz", "els", "nd"),
                          (g, el, lz, A, per[:, :K], per[:, K:2 * K], per[:, 2 * K]), want):
        _close(a, b, 1e-10, name)


def _stats(seed=3, T=4, Kk=2, V=5):
    r = np.random.default_rng(seed)
    return (r.standard_normal((T, Kk, V)), np.abs(r.standard_normal((T * V, Kk))) * 5,
            np.abs(r.standard_normal((T, Kk))) * 3)


def test_cg_objective_and_its_autograd_gradient_match_jax():
    bh, A, wz = _stats()
    T, Kk, V = bh.shape
    vf, vb = torch_dtm.variance_smoother(T, Kk, V, torch.float64)
    jvf, jvb = jax_dtm.variance_smoother(T, Kk, V, jnp.float64)
    jobj = lambda b: jax_dtm.cg_objective(b, jvf, jvb, jnp.asarray(A), jnp.asarray(wz))
    x = _t(bh).requires_grad_(True)
    f = torch_dtm.cg_objective(x, vf, vb, _t(A), _t(wz))
    g, = torch.autograd.grad(f, x)
    _close(f.detach(), jobj(jnp.asarray(bh)), 1e-10, "objective")
    _close(g, jax.grad(jobj)(jnp.asarray(bh)), 1e-10, "gradient")


def _slice_newton_inputs(S=6, Kk=4, seed=2):
    """Per slice: alpha, the Elogtheta sum of ``nd`` documents drawn from
    a Dirichlet posterior, its compensation half and ``nd``."""
    from scipy.special import digamma

    r = np.random.default_rng(seed)
    alpha = r.uniform(0.3, 2.0, (S, Kk))
    nd = r.integers(1, 40, S).astype(np.float64)
    els = np.stack([(digamma(g) - digamma(g.sum(1, keepdims=True))).sum(0)
                    for g in (r.uniform(0.2, 6.0, (int(n), Kk)) for n in nd)])
    lo = r.normal(0, 1e-12, (S, Kk))
    return alpha, els, lo, nd


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_batched_dirichlet_newton_matches_the_single_slice_one(dtype):
    """Each row of the batched Newton runs the iterations it runs when
    solved alone (the one-row ``dirichlet_newton``): the stop mask freezes
    it, not the slowest row's count (f64 to 1e-12, f32 to 1e-6); and the
    JAX package's vmap of its solver in f64."""
    alpha, els, lo, nd = _slice_newton_inputs()
    Kk = alpha.shape[1]
    tol = 1.0 / Kk**2
    t = lambda a: torch.as_tensor(a, dtype=dtype)
    M = np.maximum(nd, 1.0)
    got = torch_newton.dirichlet_newton_batched(t(alpha), t(els), t(M), 1000, tol,
                                                Elogtheta_sum_lo=t(lo))
    rows = torch.stack([torch_newton.dirichlet_newton(t(alpha[s]), t(els[s]), float(M[s]),
                                                      1000, tol, Elogtheta_sum_lo=t(lo[s]))
                        for s in range(len(nd))])
    rtol = 1e-12 if dtype == torch.float64 else 1e-6
    _close(got, rows, rtol, "batched vs single", atol=0)
    if dtype == torch.float64:
        want = jax.vmap(lambda a, e, l, n: jax_newton.dirichlet_newton(
            a, e, n, 1000, tol, Elogtheta_sum_lo=l))(*(jnp.asarray(x) for x in (alpha, els, lo, M)))
        _close(got, want, 1e-10, "batched vs JAX vmap")


def test_batched_dirichlet_newton_reads_the_host_once_an_iteration():
    """One read an iteration for all rows: as many as the slowest row's
    single-row solve, not their sum."""
    alpha, els, lo, nd = _slice_newton_inputs()
    M = np.maximum(nd, 1.0)
    with HostReads() as batched:
        torch_newton.dirichlet_newton_batched(_t(alpha), _t(els), _t(M), 1000, 1.0 / 16)
    single = []
    for s in range(len(nd)):
        with HostReads() as one:
            torch_newton.dirichlet_newton(_t(alpha[s]), _t(els[s]), float(M[s]), 1000, 1.0 / 16)
        single.append(one.n)
    assert batched.n == max(single) and sum(single) > batched.n


def test_global_update_matches_jax():
    """The batched alpha Newtons and the betahat CG from the same
    statistics: the JAX package runs every cgiter iteration, the port
    stops once CG has converged; the results agree to 1e-8."""
    bh, A, wz = _stats(seed=5, T=4, Kk=3, V=6)
    T, Kk, V = bh.shape
    alpha, els, lo, nd = _slice_newton_inputs(S=T, Kk=Kk, seed=4)
    vf, vb = torch_dtm.variance_smoother(T, Kk, V, torch.float64)
    jvf, jvb = jax_dtm.variance_smoother(T, Kk, V, jnp.float64)
    for cgiter, cgtol in ((3, 1.0 / T**2), (25, 1e-3)):
        got = torch_dtm.make_global_update(1000, 1.0 / Kk**2, cgiter, cgtol)(
            _t(alpha), _t(bh), vf, vb, _t(A), _t(wz), _t(els), _t(lo), _t(nd))
        want = jax.jit(jax_dtm.make_global_update(1000, 1.0 / Kk**2, cgiter, cgtol))(
            *(jnp.asarray(x) for x in (alpha, bh)), jvf, jvb,
            *(jnp.asarray(x) for x in (A, wz, els, lo, nd)))
        for name, a, b in zip(("alpha", "betahat", "mbeta"), got, want):
            _close(a, b, 1e-8, f"{name}, cgiter {cgiter}")
        assert not np.allclose(got[1].numpy(), bh)


def test_step_and_elbo_trace_match_jax_every_iteration():
    """The step and the bound through the user API: DTM(...).train() from
    the JAX init, 3 iterations, state and ELBO to 1e-8 each iteration."""
    jm, pm = _models()
    jstep = jax.jit(jax_dtm.make_step(jm.packed, K, jm.T, viter=5, vtol=1.0 / K**2,
                                      niter=1000, ntol=1.0 / K**2, cgiter=3,
                                      cgtol=1.0 / jm.T**2, chunk_docs=CHUNK))
    jelbo = jax.jit(jax_dtm.make_elbo(jm.packed, K, jm.T, chunk_docs=CHUNK))
    tstep = torch_dtm.make_step(pm.packed, K, pm.T, viter=5, vtol=1.0 / K**2, niter=1000,
                                ntol=1.0 / K**2, cgiter=3, cgtol=1.0 / pm.T**2,
                                chunk_docs=CHUNK, slice_id=pm.slice_id, device="cpu")
    telbo = torch_dtm.make_elbo(pm.packed, K, pm.T, chunk_docs=CHUNK)
    p = jm.packed
    jdata = tuple(jnp.asarray(a) for a in (jm.slice_id, p.terms, p.counts, p.doc_mask))
    tdata = pm._step_data()
    js, ts = jm.state, pm.state
    for it in range(1, 4):
        js, ts = jstep(js, *jdata), tstep(ts, *tdata)
        got = convert.dtm_state_to_numpy(ts)
        for f in ("alpha", "betahat", "mbeta", "gamma", "Elogtheta", "lzeta"):
            _close(got[f], getattr(js, f), 1e-8, f"{f} at iteration {it}", atol=1e-12)
        je, te = float(jnp.sum(jelbo(js, *jdata))), float(torch.sum(telbo(ts, *tdata)))
        assert abs(te - je) <= 1e-8 * abs(je), (it, te, je)

    for m in (jm, pm):
        m.train(iter=3, tol=0.0, checkelbo=1, printelbo=False, viter=5, cgiter=3)
    np.testing.assert_allclose([r.elbo for r in pm.trainer.trace],
                               [r.elbo for r in jm.trainer.trace], rtol=1e-8)
    assert all(r.delta_elbo > 0 for r in pm.trainer.trace[1:])
    for f in ("alpha", "betahat", "mbeta", "vbeta", "gamma"):
        _close(getattr(pm, f), getattr(jm, f), 1e-8, f, atol=1e-12)
    np.testing.assert_allclose(pm.topicdist([1, 2, 3]), jm.topicdist([1, 2, 3]), rtol=1e-8)
    assert pm.topics.shape == (pm.T, K, pm.V)
    np.testing.assert_array_equal(pm.topics[:, :, :3], jm.topics[:, :, :3])


def test_step_is_deterministic_and_goes_through_the_scatter(monkeypatch):
    from topicmodelsvb_jl_torch.kernels import scatter_rows as sr

    calls = []
    real = sr.scatter_rows_ref
    monkeypatch.setattr(sr, "scatter_rows_ref", lambda *a: (calls.append(a[0].shape), real(*a))[1])
    run = lambda: tt.DTM(tt.synth_corpus(**CORPUS), K, delta=1.0,
                         runtime=tt.RuntimeConfig(chunk_docs=CHUNK), device="cpu",
                         seed=9).train(iter=1, checkelbo=float("inf"), printelbo=False, cgiter=3)
    a = run()
    n_chunks = a.packed.M_pad // CHUNK
    assert calls.count((a.T * a.V, K)) == calls.count((a.T, 2 * K + 1)) == n_chunks
    b = run()
    for f in dataclasses.asdict(a.state):
        assert torch.equal(getattr(a.state, f), getattr(b.state, f)), f
    assert a.state.betahat.dtype == torch.float32


@pytest.mark.parametrize("base", ["LDA", "CTM"])
def test_basemodel_warm_start_matches_jax_exactly(base):
    corp_j, corp_p = tm.synth_corpus(**CORPUS), tt.synth_corpus(**CORPUS)
    jb = getattr(tm, base)(corp_j, K, runtime=JaxRuntimeConfig(chunk_docs=CHUNK, dtype="float64"),
                           mesh=make_mesh(n_devices=1), seed=2)
    jb.train(iter=2, checkelbo=float("inf"), printelbo=False)
    pb = getattr(tt, base)(corp_p, K, tt.RuntimeConfig(chunk_docs=CHUNK, dtype="float64"),
                           device="cpu", seed=2)
    from_np = {"LDA": convert.lda_state_from_numpy, "CTM": convert.ctm_state_from_numpy}[base]
    pb.state = from_np(jb.state._asdict(), "cpu", torch.float64)
    jm = tm.DTM(corp_j, K, delta=1.0, basemodel=jb, seed=4, mesh=make_mesh(n_devices=1),
                runtime=JaxRuntimeConfig(chunk_docs=CHUNK, dtype="float64", pad_multiple=8))
    pm = tt.DTM(corp_p, K, delta=1.0, basemodel=pb, device="cpu", seed=4,
                runtime=tt.RuntimeConfig(chunk_docs=CHUNK, dtype="float64", pad_multiple=8))
    for f in ("betahat", "alpha", "gamma", "Elogtheta", "mbeta"):
        got, want = getattr(pm.state, f).numpy(), np.asarray(getattr(jm.state, f))
        if f in ("betahat", "alpha", "gamma"):
            np.testing.assert_array_equal(got, want, err_msg=f)
        else:
            _close(got, want, 1e-12, f)
    pm.train(iter=2, checkelbo=1, printelbo=False, cgiter=3)
    assert all(np.isfinite(r.delta_elbo) for r in pm.trainer.trace)
    with pytest.raises(tt.TopicModelError, match="matching"):
        tt.DTM(corp_p, K + 1, delta=1.0, basemodel=pb, device="cpu")


def test_guards():
    with pytest.raises(tt.CorpusError, match="stamp"):
        tt.DTM(tt.synth_corpus(M=20, V=20, K=2, seed=0), 2, delta=1.0, device="cpu")
    corp = tt.synth_corpus(M=30, V=25, K=2, seed=0, n_slices=2, drift=0.1, mean_terms=8,
                           mean_tokens=12)
    for delta in (0.0, -1.0, float("inf"), float("nan")):
        with pytest.raises(ValueError, match="delta"):
            tt.DTM(corp, 2, delta=delta, device="cpu")
    packed = tt.synth_packed_nsf_scale(M=16, V=40, mean_terms=8, seed=1, chunk_docs=8)
    with pytest.raises(tt.TopicModelError, match="stamps"):
        tt.DTM(packed, 2, delta=1.0, device="cpu")
    m = tt.DTM(corp, 2, delta=1.0, device="cpu")
    with pytest.raises(ValueError, match="iteration"):
        m.train(iter=1, cgiter=0)
    m.train(iter=1, checkelbo=float("inf"), printelbo=False, cgiter=2)
    with pytest.raises(tt.TopicModelError, match="DTM"):
        tt.predict(corp, m)
    with pytest.raises(tt.TopicModelError, match="DTM"):
        tt.gendoc(m)
    with pytest.raises(ValueError, match="time-slice"):
        m.showtopics(slices=m.T + 1)
    assert repr(m) == f"Dynamic topic model with 2 topics and {m.T} time slices."


def test_check_model_dtm_branch():
    _, pm = _models()
    assert state_violations(pm) == []
    for field, value, msg in (("alpha", 0.0, "alpha must be positive"),
                              ("betahat", float("nan"), "betahat must be finite"),
                              ("mbeta", float("inf"), "mbeta must be finite"),
                              ("vbeta", -1.0, "vbeta must be positive"),
                              ("gamma", 0.0, "gamma must be positive"),
                              ("lzeta", float("nan"), "lzeta must be finite")):
        _, pm = _models()
        bad = getattr(pm.state, field).clone()
        bad.view(-1)[0] = value
        pm.state = dataclasses.replace(pm.state, **{field: bad})
        assert state_violations(pm) == [msg]
        with pytest.raises(tt.TopicModelError, match=msg):
            pm.train(iter=1, printelbo=False)


def test_dtm_checkpoint_round_trip_and_cross_load(tmp_path):
    jm, pm = _models()
    pm.train(iter=2, checkelbo=1, printelbo=False, cgiter=3)
    path = str(tmp_path / "dtm.npz")
    tt.save_checkpoint(path, pm)
    back = tt.load_checkpoint(path, pm.corp, device="cpu")
    assert isinstance(back, tt.DTM) and (back.T, back.delta, back.trained_iters) == (pm.T, 1.0, 2)
    for f in dataclasses.asdict(pm.state):
        assert torch.equal(getattr(back.state, f), getattr(pm.state, f)), f
    np.testing.assert_array_equal(back.topics, pm.topics)
    j = tm.load_checkpoint(path, jm.corp)          # and into the JAX package
    assert isinstance(j, tm.DTM) and j.T == pm.T
    np.testing.assert_array_equal(np.asarray(j.state.betahat), pm.betahat)
    np.testing.assert_array_equal(j.gamma, pm.gamma)
    for m in (back, pm):
        m.train(iter=1, checkelbo=1, printelbo=False, cgiter=3)
    np.testing.assert_array_equal(back.betahat, pm.betahat)
    assert back.trainer.trace[0].k == 3
