"""The port's CTPF slice against the JAX package, on CPU.

The host pieces (``synth_corpus``, ``pack_corpus``, bucketing) must give
byte-identical arrays; the step and the bound agree in f64 to 1e-8
relative per iteration from one injected init (the gap is the E-step's
ψ series); the kernel module's plain version is held to the Pallas kernel
in interpret mode in f32 at the JAX package's CTPF tolerance (rtol 2e-2,
atol 1e-5, tests/test_kernels.py:144-147).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.special import digamma

import topicmodelsvb_jl_tpu as tm
from topicmodelsvb_jl_tpu.kernels.ctpf_estep import ctpf_estep as jax_ctpf_estep
from topicmodelsvb_jl_tpu.models import ctpf as jax_ctpf
from topicmodelsvb_jl_tpu.ops.packing import bucketize_packed as jax_bucketize
from topicmodelsvb_jl_tpu.ops.packing import pack_corpus as jax_pack
from topicmodelsvb_jl_tpu.parallel.mesh import make_mesh
from topicmodelsvb_jl_tpu.utils.config import RuntimeConfig as JaxRuntimeConfig
import topicmodelsvb_jl_torch as tt
from topicmodelsvb_jl_torch import engine
from topicmodelsvb_jl_torch.api import TopicModelError
from topicmodelsvb_jl_torch.convert import (
    CTPF_FIELDS, ctpf_state_from_numpy, ctpf_state_to_numpy,
)
from topicmodelsvb_jl_torch.kernels.ctpf_estep import ctpf_estep, ctpf_estep_ref
from topicmodelsvb_jl_torch.models import ctpf as torch_ctpf
from topicmodelsvb_jl_torch.validate import check_model

CORPUS = dict(M=60, V=50, K=3, U=20, seed=5, mean_tokens=20, mean_terms=10,
              mean_readers=3)
CHUNK = 16
KP = 128
PACKED_FIELDS = ("terms", "counts", "doc_mask", "N", "C", "readers", "ratings", "R")


def _packed(corpus=CORPUS, dtype=np.float64):
    kw = dict(with_readers=True, pad_multiple=8, dtype=dtype)
    return jax_pack(tm.synth_corpus(**corpus), **kw), tt.pack_corpus(tt.synth_corpus(**corpus), **kw)


def _models(K, seed=3, corpus=CORPUS):
    jp, tp = _packed(corpus)
    jm = tm.CTPF(jp, K, runtime=JaxRuntimeConfig(chunk_docs=CHUNK, dtype="float64"),
                 mesh=make_mesh(n_devices=1), seed=seed)
    pm = tt.CTPF(tp, K, tt.RuntimeConfig(chunk_docs=CHUNK, dtype="float64"),
                 device="cpu", seed=seed)
    pm.state = ctpf_state_from_numpy(jm.state._asdict(), "cpu", torch.float64)
    return jm, pm


def _same_bytes(a, b, fields):
    for f in fields:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape and x.tobytes() == y.tobytes(), f


def test_synth_corpus_identical():
    a, b = tm.synth_corpus(**CORPUS), tt.synth_corpus(**CORPUS)
    assert a.shape == b.shape == (60, 50, 20)
    assert a.vocab == b.vocab and a.users == b.users
    for x, y in zip(a.docs, b.docs):
        assert (x.terms, x.counts, x.readers, x.ratings) == (y.terms, y.counts,
                                                             y.readers, y.ratings)
    c = b.copy()
    assert c.docs == b.docs and c.docs is not b.docs


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_pack_corpus_byte_identical_with_readers(dtype):
    a, b = _packed(dtype=dtype)
    _same_bytes(a, b, PACKED_FIELDS)
    for f in ("M", "V", "L", "U", "Rmax", "max_count", "max_rating"):
        assert getattr(a, f) == getattr(b, f), f
    a, b = (jax_bucketize(a, chunk=CHUNK, pad_multiple=8),
            tt.bucketize_packed(b, chunk=CHUNK, pad_multiple=8))
    assert len(a.segments) >= 2 and len(a.segments) == len(b.segments)
    _same_bytes(a, b, PACKED_FIELDS + ("order", "inv_order"))
    for sa, sb in zip(a.segments, b.segments):
        _same_bytes(sa, sb, ("terms", "counts", "doc_mask"))


FIELDS = ("alef", "bet", "gimel", "gimel_old", "dalet", "he", "vav", "zayin",
          "zayin_old", "het")


def test_step_and_elbo_match_jax_every_iteration():
    K, iters = 5, 3
    jm, pm = _models(K)
    p = jm.packed
    kw = dict(viter=10, vtol=1.0 / K**2, chunk_docs=CHUNK)
    jstep = jax.jit(jax_ctpf.make_step(p, K, axis_name=None, use_pallas=False, **kw))
    jelbo = jax.jit(jax_ctpf.make_elbo(p, K, chunk_docs=CHUNK))
    tstep = torch_ctpf.make_step(pm.packed, K, device="cpu", **kw)
    telbo = torch_ctpf.make_elbo(pm.packed, K, chunk_docs=CHUNK)
    seg = lambda f: tuple(jnp.asarray(getattr(s, f)) for s in p.segments)
    jdata = (seg("terms"), seg("counts"), jnp.asarray(p.readers), jnp.asarray(p.ratings),
             seg("doc_mask"))
    tdata = pm._step_data()
    js, ts = jm.state, pm.state
    for it in range(1, iters + 1):
        js, ts = jstep(js, *jdata), tstep(ts, *tdata)
        got = ctpf_state_to_numpy(ts)
        for f in FIELDS:
            np.testing.assert_allclose(got[f], np.asarray(getattr(js, f)), rtol=1e-8,
                                       atol=1e-12, err_msg=f"{f} at iteration {it}")
        je, te = float(jnp.sum(jelbo(js, *jdata))), float(torch.sum(telbo(ts, *tdata)))
        assert abs(te - je) <= 1e-8 * abs(je), (it, te, je)


def test_train_and_recommendations_match_jax():
    """train(), the accessors, and the recommender surface on one state."""
    K, iters = 4, 3
    jm, pm = _models(K, seed=7)
    assert pm.R == jm.R and pm.libs == jm.libs
    assert pm.drecs[0] == jm.drecs[0] and pm.urecs[2] == jm.urecs[2]   # unranked
    jm.train(iter=iters, checkelbo=1, printelbo=False)
    pm.train(iter=iters, checkelbo=1, printelbo=False)
    np.testing.assert_allclose([r.elbo for r in pm.trainer.trace],
                               [r.elbo for r in jm.trainer.trace], rtol=1e-8)
    for f in ("alef", "bet", "gimel", "dalet", "he", "vav", "zayin", "het"):
        np.testing.assert_allclose(getattr(pm, f), getattr(jm, f), rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(pm.topicdist([1, 5]), jm.topicdist([1, 5]), rtol=1e-8)
    # rankings on the very same state
    pm.state = ctpf_state_from_numpy(jm.state._asdict(), "cpu", torch.float64)
    pm._finalize()
    np.testing.assert_array_equal(pm.topics, jm.topics)        # alef ./ bet
    np.testing.assert_allclose(pm.scores, jm.scores, rtol=1e-12)
    assert pm.scores.shape == (pm.M, pm.U)
    for d in (0, 7, pm.M - 1):
        assert pm.drecs[d] == jm.drecs[d]
    for u in (0, 3, pm.U - 1):
        assert pm.urecs[u] == jm.urecs[u]
    assert len(pm.drecs) == pm.M and len(pm.urecs[:3]) == 3


def test_recommendations_from_per_row_products():
    """Past _SCORES_DENSE_MAX the rows come from matrix-vector products
    and rank exactly as the dense scores do."""
    _, pm = _models(3)
    pm.train(iter=2, checkelbo=float("inf"), printelbo=False)
    dense = (pm.drecs[4], pm.urecs[1])
    pm._SCORES_DENSE_MAX = 0
    pm._finalize()
    assert pm._scores_dev is None and (pm.drecs[4], pm.urecs[1]) == dense


def test_no_users_trains():
    """U = 0: one placeholder user, every rating 0, as in the JAX package."""
    corpus = dict(CORPUS, U=0)
    jm, pm = _models(3, corpus=corpus)
    assert pm.U == 0 and pm.state.he.shape == (3, 1) and pm.libs == []
    jm.train(iter=2, checkelbo=1, printelbo=False)
    pm.train(iter=2, checkelbo=1, printelbo=False)
    np.testing.assert_allclose([r.elbo for r in pm.trainer.trace],
                               [r.elbo for r in jm.trainer.trace], rtol=1e-8)
    assert pm.he.shape == (3, 0) and pm.drecs[0] == []


def _chunk_inputs(K, B=16, L=24, R=8, V=40, U=12, seed=3):
    """One chunk of documents with a warm state; the last 3 are padding."""
    r = np.random.default_rng(seed)
    alef = 0.1 + r.gamma(2.0, 1.0, size=(K, V))
    he = 0.1 + r.gamma(2.0, 1.0, size=(K, U))
    terms = r.integers(0, V, size=(B, L)).astype(np.int32)
    counts = (1 + r.poisson(0.4, size=(B, L))).astype(np.float32)
    counts *= np.arange(L)[None, :] < r.integers(3, L, size=B)[:, None]
    readers = r.integers(0, U, size=(B, R)).astype(np.int32)
    ratings = (np.arange(R)[None, :] < r.integers(1, R, size=B)[:, None]).astype(np.float32)
    terms[counts == 0] = 0
    readers[ratings == 0] = 0
    doc_mask = np.ones(B, np.float32)
    doc_mask[-3:] = 0.0
    counts[-3:] = 0.0
    ratings[-3:] = 0.0
    dalet, bet, vav, het = (r.uniform(0.5, 3.0, K) for _ in range(4))
    f = lambda a: np.asarray(a, np.float32)
    gimel = 0.1 + r.gamma(2.0, 1.0, size=(B, K))
    zayin = 0.1 + r.gamma(2.0, 1.0, size=(B, K))
    return dict(ealefT=f(np.exp(digamma(alef)).T), eheT=f(np.exp(digamma(he)).T),
                terms=terms, counts=counts, readers=readers, ratings=ratings,
                doc_mask=doc_mask, inv_db=f(1 / (dalet * bet)), inv_dv=f(1 / (dalet * vav)),
                inv_hv=f(1 / (het * vav)), gimel=f(gimel), gimel_old=f(gimel * 1.1),
                zayin=f(zayin), zayin_old=f(zayin * 0.9))


ARG_NAMES = ("ealefT", "eheT", "terms", "counts", "readers", "ratings", "doc_mask",
             "inv_db", "inv_dv", "inv_hv", "gimel", "gimel_old", "zayin", "zayin_old")
HYP = dict(c_hyper=0.1, g_hyper=0.1)


@pytest.mark.parametrize("K", [9, 16])
def test_ctpf_estep_ref_matches_pallas(K):
    """Padded to Kp = 128 by the JAX package's conventions (models/ctpf.py:
    229-245): tables, the [K] vectors and the state padded with 0."""
    x = _chunk_inputs(K)
    vtol = 1.0 / K**2
    padk = lambda a: jnp.pad(jnp.asarray(a), [(0, 0)] * (a.ndim - 1) + [(0, KP - K)])
    want = jax_ctpf_estep(
        padk(x["ealefT"])[jnp.asarray(x["terms"])], padk(x["eheT"])[jnp.asarray(x["readers"])],
        jnp.asarray(x["counts"]), jnp.asarray(x["ratings"]), jnp.asarray(x["doc_mask"]),
        padk(x["inv_db"]), padk(x["inv_dv"]), padk(x["inv_hv"]),
        padk(x["gimel"]), padk(x["gimel_old"]), padk(x["zayin"]), padk(x["zayin_old"]),
        viter=5, vtol=vtol, n_topics=K, interpret=True, **HYP)
    got = ctpf_estep_ref(*(torch.tensor(x[k]) for k in ARG_NAMES), viter=5, vtol=vtol, **HYP)
    for name, a, b in zip(("gimel", "gimel_old", "zayin", "zayin_old", "wa", "wh"),
                          got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b)[..., :K], rtol=2e-2, atol=1e-5,
                                   err_msg=f"{name} diverged")


def test_ctpf_estep_wrapper_takes_plain_version_on_cpu():
    x = _chunk_inputs(6, seed=4)
    args = tuple(torch.tensor(x[k]) for k in ARG_NAMES)
    before = ctpf_estep.launches
    got = ctpf_estep(*args, viter=4, vtol=1e-3, **HYP)
    want = ctpf_estep_ref(*args, viter=4, vtol=1e-3, **HYP)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert ctpf_estep.launches == before
    for a, k in zip(got[:4], ARG_NAMES[10:]):            # padded documents frozen
        np.testing.assert_array_equal(a.numpy()[-3:], x[k][-3:])
    assert torch.all(got[4][-3:] == 0) and torch.all(got[5][-3:] == 0)
    with pytest.raises(ValueError, match="no kernel"):
        ctpf_estep(*(a.to("meta") for a in args), viter=2, vtol=1e-3, **HYP)


def test_reader_model_needs_reader_arrays_and_valid_ids():
    p = tt.synth_packed_nsf_scale(M=100, V=50, mean_terms=10, seed=1)
    with pytest.raises(ValueError, match="reader arrays"):
        tt.CTPF(p, 3, device="cpu")
    _, tp = _packed()
    tp.readers[0, 0] = tp.U
    with pytest.raises(ValueError, match="reader ids"):
        tt.CTPF(tp, 3, tt.RuntimeConfig(chunk_docs=CHUNK), device="cpu")


def test_check_model_rejects_nonpositive_alef():
    _, pm = _models(3)
    check_model(pm)
    pm.state.alef[0, 0] = 0.0
    pm.state.het[1] = -1.0
    with pytest.raises(TopicModelError, match="alef must be positive; het must be positive"):
        pm.train(iter=1)


def test_synchronize_reads_no_beta(monkeypatch):
    """The trainer's end-of-run wait picks the state's first tensor field
    (CTPF has no beta) or the device it is given."""
    _, pm = _models(3)
    engine._synchronize(pm.state)                    # CPU: nothing to wait for
    seen = []
    monkeypatch.setattr(torch.cuda, "synchronize", seen.append)
    engine._synchronize(pm.state, "cuda:0")
    assert seen == [torch.device("cuda:0")]
    pm.train(iter=2, checkelbo=float("inf"), printelbo=False)
    assert pm.trainer.device == torch.device("cpu") and pm.trainer.trace[-1].span == 2


def test_convert_round_trip():
    jm, pm = _models(3)
    arrays = ctpf_state_to_numpy(pm.state)
    assert set(arrays) == set(CTPF_FIELDS) and len(CTPF_FIELDS) == 17
    for f in CTPF_FIELDS:
        np.testing.assert_array_equal(arrays[f], np.asarray(getattr(jm.state, f)))
    back = ctpf_state_from_numpy(arrays, "cpu", torch.float32)
    assert back.he.dtype == torch.float32 and back.he.shape == (3, pm.U)
