"""The port's LDA slice against the JAX package, on CPU.

Both packages train from the same JAX init, injected into the port
through ``convert.py`` (``jax.random`` and ``torch.Generator`` draw
different numbers).  In f64 the trajectories agree to 1e-8 relative per
iteration (the JAX package's oracle tolerance); what separates them is
the E-step's ψ — the port uses the kernels' shift-by-8 series, whose
truncation error (~2.5e-10 absolute) the JAX CPU path does not have.
"""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import topicmodelsvb_jl_tpu as tm
from topicmodelsvb_jl_tpu.datasets import synth_packed_nsf_scale as jax_synth
from topicmodelsvb_jl_tpu.models import lda as jax_lda
from topicmodelsvb_jl_tpu.ops.packing import bucketize_packed as jax_bucketize
from topicmodelsvb_jl_tpu.ops.packing import pack_corpus as jax_pack
from topicmodelsvb_jl_tpu.parallel.mesh import make_mesh
from topicmodelsvb_jl_tpu.utils.config import RuntimeConfig as JaxRuntimeConfig
import topicmodelsvb_jl_torch as tt
from topicmodelsvb_jl_torch.api import TopicModelError
from topicmodelsvb_jl_torch.convert import (
    LDA_FIELDS, lda_state_from_numpy, lda_state_to_numpy,
)
from topicmodelsvb_jl_torch.models import lda as torch_lda
from topicmodelsvb_jl_torch.validate import check_model

CORPUS = dict(M=300, V=200, mean_terms=20, seed=1, chunk_docs=16)
CHUNK = 16


def _models(K, seed=3):
    jm = tm.LDA(jax_synth(**CORPUS), K,
                runtime=JaxRuntimeConfig(chunk_docs=CHUNK, dtype="float64"),
                mesh=make_mesh(n_devices=1), seed=seed)
    pm = tt.LDA(tt.synth_packed_nsf_scale(**CORPUS), K,
                tt.RuntimeConfig(chunk_docs=CHUNK, dtype="float64"),
                device="cpu", seed=seed)
    pm.state = lda_state_from_numpy(jm.state._asdict(), "cpu", torch.float64)
    return jm, pm


def _assert_fields(jax_fields, torch_fields, names, where):
    for f in names:
        np.testing.assert_allclose(np.asarray(torch_fields[f]), np.asarray(jax_fields[f]),
                                   rtol=1e-8, atol=1e-12, err_msg=f"{f} at {where}")


@pytest.mark.parametrize("M,chunk", [(300, 16), (77, 8)])
def test_packing_byte_identical(M, chunk):
    kw = dict(CORPUS, M=M, chunk_docs=chunk)
    a, b = jax_synth(**kw), tt.synth_packed_nsf_scale(**kw)
    a, b = (jax_bucketize(a, chunk=chunk, pad_multiple=8),
            tt.bucketize_packed(b, chunk=chunk, pad_multiple=8))
    assert len(a.segments) >= 2 and len(a.segments) == len(b.segments)
    for f in ("terms", "counts", "doc_mask", "N", "C", "order", "inv_order"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape and x.tobytes() == y.tobytes(), f
    for f in ("M", "V", "L", "max_count", "n_shards", "chunk"):
        assert getattr(a, f) == getattr(b, f), f
    for sa, sb in zip(a.segments, b.segments):
        assert (sa.L, sa.n_local, sa.loc_start) == (sb.L, sb.n_local, sb.loc_start)
        for f in ("terms", "counts", "doc_mask"):
            x, y = getattr(sa, f), getattr(sb, f)
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), f


def test_step_and_elbo_match_jax_every_iteration():
    """make_step/make_elbo on the bucketed corpus, state by state."""
    K, iters = 5, 4
    jm, pm = _models(K)
    p = jm.packed
    assert len(p.segments) >= 2
    kw = dict(viter=10, vtol=1.0 / K**2, niter=1000, ntol=1.0 / K**2,
              chunk_docs=CHUNK)
    jstep = jax.jit(jax_lda.make_step(p, K, axis_name=None, use_pallas=False, **kw))
    jelbo = jax.jit(jax_lda.make_elbo(p, K, chunk_docs=CHUNK, use_pallas=False))
    tstep = torch_lda.make_step(pm.packed, K, device="cpu", **kw)
    telbo = torch_lda.make_elbo(pm.packed, K, chunk_docs=CHUNK)
    jdata = tuple(tuple(jnp.asarray(getattr(s, f)) for s in p.segments)
                  for f in ("terms", "counts", "doc_mask"))
    tdata = pm._data_arrays()
    js, ts = jm.state, pm.state
    for it in range(1, iters + 1):
        js = jstep(js, *jdata, jnp.asarray(float(p.M)))
        ts = tstep(ts, *tdata, float(pm.M))
        _assert_fields(js._asdict(), lda_state_to_numpy(ts),
                       ("alpha", "beta", "gamma", "Elogtheta", "Elogtheta_old"),
                       f"iteration {it}")
        je, te = float(jnp.sum(jelbo(js, *jdata))), float(torch.sum(telbo(ts, *tdata)))
        assert abs(te - je) <= 1e-8 * abs(je), (it, te, je)


def test_train_matches_jax():
    """The slice through the user API: LDA(...).train() and accessors."""
    K, iters = 4, 5
    jm, pm = _models(K, seed=7)
    jm.train(iter=iters, checkelbo=1, printelbo=False)
    pm.train(iter=iters, checkelbo=1, printelbo=False)
    jel = [r.elbo for r in jm.trainer.trace]
    tel = [r.elbo for r in pm.trainer.trace]
    assert len(tel) == iters
    np.testing.assert_allclose(tel, jel, rtol=1e-8)
    got = {f: getattr(pm, f) for f in ("alpha", "beta", "gamma", "Elogtheta")}
    want = {f: getattr(jm, f) for f in ("alpha", "beta", "gamma", "Elogtheta")}
    _assert_fields(want, got, got, "the end")
    np.testing.assert_allclose(pm.topicdist([1, 2, 3]), jm.topicdist([1, 2, 3]), rtol=1e-8)
    assert pm.elbo == pytest.approx(jm.elbo, rel=1e-8)
    np.testing.assert_array_equal(pm.topics[:, :5], jm.topics[:, :5])


def test_train_prints_and_stops_at_tol(capsys):
    pm = tt.LDA(tt.synth_packed_nsf_scale(**CORPUS), 3,
                tt.RuntimeConfig(chunk_docs=CHUNK), device="cpu", seed=2)
    pm.train(iter=50, tol=1e6, checkelbo=2)
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines and lines[0].startswith("2 ∆elbo: ")
    assert len(pm.trainer.trace) == 2 and pm.trained_iters == 2
    s = pm.trainer.summary()
    assert s["iterations"] == 2 and s["docs_per_s"] > 0 and s["final_elbo"] == pm.elbo
    assert pm.state.beta.dtype == torch.float32


def test_same_seed_is_bitwise_deterministic():
    run = lambda seed: tt.LDA(tt.synth_packed_nsf_scale(**CORPUS), 4,
                              tt.RuntimeConfig(chunk_docs=CHUNK), device="cpu",
                              seed=seed).train(iter=3, checkelbo=float("inf"),
                                               printelbo=False)
    a, b, c = run(9), run(9), run(10)
    for f in ("alpha", "beta", "gamma"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    assert not np.array_equal(a.beta, c.beta)


def test_check_model_rejects_a_broken_state():
    pm = tt.LDA(tt.synth_packed_nsf_scale(**CORPUS), 3,
                tt.RuntimeConfig(chunk_docs=CHUNK), device="cpu")
    check_model(pm)
    pm.state.gamma[0, 0] = -1.0
    pm.state.Elogtheta[1, 0] = float("nan")
    with pytest.raises(TopicModelError, match="gamma must be positive; "
                                              "Elogtheta must be finite"):
        pm.train(iter=1)


def test_model_rejects_bad_input():
    p = tt.synth_packed_nsf_scale(**CORPUS)
    if not torch.cuda.is_available():   # the default device is CUDA, and no fallback
        with pytest.raises(RuntimeError, match="device 'cuda': no CUDA device"):
            tt.LDA(p, 3)
    with pytest.raises(ValueError, match="positive"):
        tt.LDA(p, 0, device="cpu")
    with pytest.raises(TypeError, match="PackedCorpus"):
        tt.LDA([[1, 2]], 3, device="cpu")
    bad = tt.bucketize_packed(p, chunk=CHUNK, pad_multiple=8)
    bad.segments[0].terms[0, 0] = p.V
    with pytest.raises(ValueError, match="term ids"):
        tt.LDA(bad, 3, device="cpu")
    with pytest.raises(tt.CorpusError):
        tt.LDA(p, 3, device="cpu").topicdist(p.M + 1)


@pytest.mark.parametrize("family", ["LDA", "fLDA", "CTM", "fCTM", "CTPF"])
def test_topicdist_outside_the_corpus_raises_corpus_error(family):
    """A document index outside 1..M raises CorpusError in both packages,
    on the same corpus; the port's is its own ``corpus.CorpusError``."""
    if family == "CTPF":
        kw = dict(M=40, V=30, K=3, U=10, seed=2, mean_tokens=12, mean_terms=8,
                  mean_readers=2)
        jp = jax_pack(tm.synth_corpus(**kw), with_readers=True)
        tp = tt.pack_corpus(tt.synth_corpus(**kw), with_readers=True)
    else:
        jp, tp = jax_synth(**CORPUS), tt.synth_packed_nsf_scale(**CORPUS)
    jm = getattr(tm, family)(jp, 3, runtime=JaxRuntimeConfig(chunk_docs=CHUNK),
                             mesh=make_mesh(n_devices=1), seed=1)
    pm = getattr(tt, family)(tp, 3, tt.RuntimeConfig(chunk_docs=CHUNK), device="cpu", seed=1)
    assert pm.M == jp.M
    for d in (0, pm.M + 1, [1, pm.M + 1]):
        with pytest.raises(tm.CorpusError):
            jm.topicdist(d)
        with pytest.raises(tt.CorpusError, match="outside corpus range"):
            pm.topicdist(d)
    assert tt.CorpusError is tt.corpus.CorpusError and tt.DocumentError is tt.corpus.DocumentError
    assert pm.topicdist([1, pm.M]).shape == (2, 3)


def test_convert_round_trip():
    jm, pm = _models(3)
    arrays = lda_state_to_numpy(pm.state)
    assert set(arrays) == set(LDA_FIELDS)
    for f in LDA_FIELDS:
        np.testing.assert_array_equal(arrays[f], np.asarray(getattr(jm.state, f)))
    back = lda_state_from_numpy(arrays, "cpu", torch.float32)
    assert back.beta.dtype == torch.float32 and back.gamma.shape == pm.state.gamma.shape


def test_import_loads_no_jax():
    code = ("import sys, topicmodelsvb_jl_torch, topicmodelsvb_jl_torch.convert, "
            "topicmodelsvb_jl_torch.validate, topicmodelsvb_jl_torch.engine, "
            "topicmodelsvb_jl_torch.corpus, topicmodelsvb_jl_torch.datasets, "
            "topicmodelsvb_jl_torch.evaluate, topicmodelsvb_jl_torch.native, "
            "topicmodelsvb_jl_torch.utils.display; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib', "
            "'topicmodelsvb_jl_tpu'))]; print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
