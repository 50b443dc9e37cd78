"""The port's StreamingFLDA, StreamingCTM, StreamingFCTM, StreamingHMTM and
StreamingDTM against the JAX package's, on the CPU in float64, each family
a case of one parametrised test per check (the helpers and tolerances are
``test_torch_streaming.py``'s): ``train`` per iteration and
``train_online`` per epoch to 1e-8 from the JAX init, the streamed
trajectory against the port's in-memory model to 1e-10, the batch
partition bitwise, checkpoints crossing both ways and resuming, and the
JAX multi-process directory format on one process.
"""

import numpy as np
import pytest
import torch

from test_torch_streaming import (
    RTOL_SELF, assert_same, check_checkpoints, check_directory_format, follow_online,
    follow_train, host, lda_packed, pair, port_packed,
)
from topicmodelsvb_jl_tpu.ops.packing import unit_counts
import topicmodelsvb_jl_torch as tt
from topicmodelsvb_jl_torch import streaming as pst
from topicmodelsvb_jl_torch.engine import Trainer
from topicmodelsvb_jl_torch.models import dtm as dtm_mod
from topicmodelsvb_jl_torch.utils.config import TrainConfig


def dtm_slices(pk, T=3):
    return (np.arange(pk.M_pad) % T).astype(np.int32)


# name -> (corpus, ctor kwargs from the corpus, train-only kwargs, api class)
FAMILIES = {
    "StreamingFLDA": (lda_packed, lambda pk: {}, {}, "fLDA"),
    "StreamingCTM": (lda_packed, lambda pk: {}, {}, "CTM"),
    "StreamingFCTM": (lda_packed, lambda pk: {}, {}, "fCTM"),
    "StreamingHMTM": (lambda: unit_counts(lda_packed()), lambda pk: {}, {}, "HMTM"),
    "StreamingDTM": (lda_packed, lambda pk: dict(T=3, slice_id=dtm_slices(pk)),
                     dict(cgiter=5), None),
}
NAMES = list(FAMILIES)


def case(name):
    make, ctor, train_kw, api_name = FAMILIES[name]
    pk = make()
    return pk, ctor(pk), train_kw, api_name


@pytest.mark.parametrize("name", NAMES)
def test_train_follows_jax_per_iteration(name):
    pk, ctor, train_kw, _ = case(name)
    j, p = pair(name, pk, **ctor)
    follow_train(j, p, 3, name, viter=4, **train_kw)


def _in_memory(name, pk, ctor, train_kw, api_name, iters):
    """(globals and per-document state by name, bound trace) of the port's
    in-memory model from seed 3, the documents in packed-row order."""
    if api_name is not None:
        m = getattr(tt, api_name)(pk, 3, tt.RuntimeConfig(chunk_docs=16, dtype="float64"),
                                  device="cpu", seed=3)
        m.train(iter=iters, tol=0.0, viter=4, printelbo=False, **train_kw)
        rows = m._doc_rows()
        fields = {f: host(getattr(m.state, f)) for f in type(m.state).__dataclass_fields__}
        return fields, rows, [r.elbo for r in m.trainer.trace]
    # DTM from its slice ids: the step and bound of models/dtm.py
    T, sid = ctor["T"], ctor["slice_id"]
    state = dtm_mod.init(torch.Generator().manual_seed(3), pk, 3, T, torch.float64, "cpu")
    cfg = TrainConfig(iter=iters, tol=0.0, viter=4, printelbo=False).resolved(3)
    step = dtm_mod.make_step(pk, 3, T, cfg.viter, cfg.vtol, cfg.niter, cfg.ntol,
                             train_kw["cgiter"], 1.0 / T**2, 16, sid, "cpu")
    elbo = dtm_mod.make_elbo(pk, 3, T, 16)
    data = (torch.as_tensor(sid, dtype=torch.int64), torch.as_tensor(pk.terms),
            torch.as_tensor(pk.counts, dtype=torch.float64),
            torch.as_tensor(pk.doc_mask, dtype=torch.float64))
    tr = Trainer(step, elbo, data, data, M=pk.M, device="cpu", printer=lambda s: None)
    state = tr.train(state, cfg)
    fields = {f: host(getattr(state, f)) for f in type(state).__dataclass_fields__}
    return fields, np.arange(pk.M), [r.elbo for r in tr.trace]


@pytest.mark.parametrize("name", NAMES)
def test_streamed_trajectory_is_the_in_memory_one(name):
    pk, ctor, train_kw, api_name = case(name)
    pp = port_packed(pk)
    s = getattr(pst, name)(pp, 3, batch_docs=32, chunk_docs=16, dtype=torch.float64,
                           seed=3, device="cpu", **ctor)
    s.train(iter=3, tol=0.0, viter=4, printelbo=False, **train_kw)
    fields, rows, trace = _in_memory(name, pp, ctor, train_kw, api_name, 3)
    for n in s._globals:
        np.testing.assert_allclose(host(getattr(s, n)), fields[n], rtol=RTOL_SELF,
                                   atol=1e-13, err_msg=n)
    real = pk.counts[: pk.M] > 0
    for n in s._doc_state:
        got, want = getattr(s, n)[: s.M], fields[n][rows]
        if n in ("tau", "tau_old") and name != "StreamingHMTM":
            # past a length bucket's width the in-memory tau stays 0.5;
            # the documents' real tokens are what the models share
            got, want = got[real], want[:, : got.shape[1]][real]
        np.testing.assert_allclose(got, want, rtol=RTOL_SELF, atol=1e-13, err_msg=n)
    np.testing.assert_allclose([t[1] for t in s.trace], trace, rtol=RTOL_SELF)


@pytest.mark.parametrize("name", NAMES)
def test_batch_docs_changes_no_bit(name):
    pk, ctor, train_kw, _ = case(name)
    pp = port_packed(pk)
    runs = []
    for batch in (96, 32, 16):
        s = getattr(pst, name)(pp, 3, batch_docs=batch, chunk_docs=16, dtype=torch.float64,
                               seed=3, device="cpu", **ctor)
        s.train(iter=2, tol=0.0, viter=4, printelbo=False, **train_kw)
        runs.append(s)
    for s in runs[1:]:
        assert_same(s, runs[0], 0, f"{name} batch_docs {s.batch_docs}")


@pytest.mark.parametrize("name", NAMES)
def test_train_online_follows_jax_per_epoch(name):
    pk, ctor, train_kw, _ = case(name)
    j, p = pair(name, pk, **ctor)
    follow_online(j, p, 2, name, viter=4, tau0=8.0, shuffle_seed=5, **train_kw)


@pytest.mark.parametrize("name", NAMES)
def test_checkpoints_cross_and_resume(name, tmp_path):
    pk, ctor, train_kw, _ = case(name)
    check_checkpoints(name, pk, tmp_path, dict(viter=4, **train_kw),
                      dict(viter=4, tau0=8.0, shuffle_seed=5, **train_kw), **ctor)


@pytest.mark.parametrize("name", NAMES)
def test_jax_directory_format_loads_on_one_process(name, tmp_path):
    pk, ctor, train_kw, _ = case(name)
    check_directory_format(name, pk, tmp_path, dict(viter=4, **train_kw), **ctor)


def test_family_errors():
    pk = port_packed(lda_packed())
    with pytest.raises(ValueError, match="order-preserving"):
        pst.StreamingHMTM(pk, 3, device="cpu")          # condensed: counts > 1
    d = pst.StreamingDTM(pk, 3, T=3, slice_id=dtm_slices(pk), batch_docs=32, chunk_docs=16,
                         device="cpu")
    with pytest.raises(ValueError, match="unsupported"):
        d.to_model()
    with pytest.raises(ValueError, match="slice_id"):
        pst.StreamingDTM(pk, 3, T=2, slice_id=dtm_slices(pk), device="cpu")
    with pytest.raises(ValueError, match="positive"):
        d.train(iter=1, cgiter=0, printelbo=False)


def test_flda_to_model_carries_tau():
    pp = port_packed(lda_packed(M=64, V=40, seed=13))
    f = pst.StreamingFLDA(pp, 3, batch_docs=32, chunk_docs=16, dtype=torch.float64, seed=3,
                          device="cpu")
    f.train(iter=2, viter=3, checkelbo=float("inf"), printelbo=False)
    mf = f.to_model()
    np.testing.assert_array_equal(host(mf.state.kappa), host(f.kappa))
    tau = host(mf.state.tau)
    np.testing.assert_array_equal(tau[mf._doc_rows()], f.tau[: f.M, : tau.shape[1]])
