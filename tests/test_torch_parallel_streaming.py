"""The port's streaming models on two processes (a gloo group on the CPU,
``tests/torch_mp_worker.py``) against one process, in f64.

Each process sweeps its own L-row slice of every global batch, and the
statistics and the bound are reduced once a sweep (online: once a global
minibatch).  The global batch partition does not depend on the process
count, so batch CAVI and online SVI follow the one-process run to 1e-10
(the order of the reduction is all that differs), with the two ranks bit
for bit equal on the globals and the bound.  A two-process checkpoint
directory (``proc{p}.npz`` and ``manifest.json``) loads in one process of
either package and resumes, and (slow) a directory written by 2 processes
resumes on 4 and one written by 4 resumes on 2.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from topicmodelsvb_jl_tpu import streaming as jst
from topicmodelsvb_jl_tpu.ops import packing as jpk
import topicmodelsvb_jl_torch as tt

import torch_mp_worker as W
from test_torch_parallel import TIMEOUT, WORLD

RTOL = 1e-10
CASES = [(name, mode) for name in ("StreamingLDA", "StreamingCTPF")
         for mode in ("batch", "online")]


def one_process(name, mode, pk):
    m = getattr(tt, name)(pk, W.K, dtype=torch.float64, device="cpu", **W.STREAM)
    if mode == "batch":
        return m.train(iter=W.ITERS, checkelbo=1, printelbo=False)
    return m.train_online(epochs=2, checkelbo=1, printelbo=False, tau0=4.0)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    job = str(tmp_path_factory.mktemp("stream"))
    launch = W.Launch(job, "stream", WORLD)
    try:
        pk_lda, pk_ctpf = W.stream_packed(tt)
        pks = {"StreamingLDA": pk_lda, "StreamingCTPF": pk_ctpf}
        single = {(n, mode): one_process(n, mode, pks[n]) for n, mode in CASES}
    finally:
        outs = launch.finish(TIMEOUT)
    return dict(outs=outs, single=single, pk=pk_lda, job=job)


@pytest.mark.parametrize("name,mode", CASES)
def test_two_processes_follow_one(runs, name, mode):
    o0, o1 = runs["outs"]
    m = runs["single"][(name, mode)]
    key = f"{name}/{mode}"
    np.testing.assert_array_equal(o0[f"{key}/trace"], o1[f"{key}/trace"])
    np.testing.assert_allclose(o0[f"{key}/trace"], [t[1] for t in m.trace], rtol=RTOL)
    for n in m._globals:
        np.testing.assert_array_equal(o0[f"{key}/{n}"], o1[f"{key}/{n}"], err_msg=n)
        np.testing.assert_allclose(o0[f"{key}/{n}"], getattr(m, n).numpy(), rtol=RTOL,
                                   atol=1e-13, err_msg=n)
    rows = np.concatenate([o0[f"{key}/rows"], o1[f"{key}/rows"]])
    assert sorted(rows.tolist()) == list(range(m.M_rows))   # the ranks cover every row once
    for n in m._doc_state:
        got = np.concatenate([o0[f"{key}/doc_{n}"], o1[f"{key}/doc_{n}"]])
        np.testing.assert_allclose(got, np.asarray(getattr(m, n))[rows], rtol=RTOL,
                                   atol=1e-13, err_msg=n)


def test_two_process_checkpoint_loads_in_one_process_of_either_package(runs):
    """The directory the two processes wrote at iteration 2: one process of
    the port holds the one-process state of iteration 2 and resumes to
    the two processes' iteration 3; the JAX package reads the same rows."""
    path = os.path.join(runs["job"], "stream_ckpt")
    assert sorted(os.listdir(path)) == ["manifest.json", "proc0.npz", "proc1.npz"]
    back = tt.load_streaming_checkpoint(path, runs["pk"], device="cpu")
    assert (back.batch_docs, back._nproc, back.trained_iters) == (32, 1, 2)
    ref = tt.StreamingLDA(runs["pk"], W.K, dtype=torch.float64, device="cpu", **W.STREAM)
    ref.train(iter=2, checkelbo=1, printelbo=False)
    for n in ref._doc_state:
        np.testing.assert_allclose(getattr(back, n), getattr(ref, n), rtol=RTOL, atol=1e-13)
    np.testing.assert_allclose([t[1] for t in back.trace], [t[1] for t in ref.trace], rtol=RTOL)
    back.train(iter=1, checkelbo=1, printelbo=False)
    np.testing.assert_allclose(back.beta.numpy(), runs["outs"][0]["ckpt/beta3"], rtol=RTOL,
                               atol=1e-13)
    pk = runs["pk"]   # the same arrays as the JAX package's PackedCorpus
    jm = jst.load(path, jpk.PackedCorpus(**{f.name: getattr(pk, f.name)
                                            for f in dataclasses.fields(jpk.PackedCorpus)}))
    again = tt.load_streaming_checkpoint(path, runs["pk"], device="cpu")
    for n in ref._doc_state:
        np.testing.assert_array_equal(np.asarray(getattr(jm, n)), getattr(again, n), err_msg=n)
    for n in ref._globals:
        np.testing.assert_array_equal(np.asarray(getattr(jm, n)), getattr(again, n).numpy())


@pytest.mark.slow
def test_elastic_restore_any_process_count(tmp_path):
    """Elastic N -> M restore (the JAX package's
    ``tests/test_streaming_multiprocess.py`` twin): a 2-process checkpoint
    directory resumes on 4 processes and a 4-process one on 2, each rank
    continuing the one-process trajectory to 1e-10 with its own rows."""
    pk = W.stream_packed(tt)[0]
    ref = tt.StreamingLDA(pk, W.K, dtype=torch.float64, device="cpu", **W.STREAM)
    ref.train(iter=2 * W.ELASTIC_ITERS, tol=0.0, checkelbo=1, printelbo=False)
    ref_trace = [t[1] for t in ref.trace]
    for n_save, n_resume in ((2, 4), (4, 2)):
        job = str(tmp_path / f"ck_{n_save}to{n_resume}")
        os.makedirs(job)
        saved = W.Launch(job, "elastic_save", n_save).finish(TIMEOUT)
        np.testing.assert_allclose(saved[0]["trace"], ref_trace[:W.ELASTIC_ITERS], rtol=RTOL)
        manifest = os.path.join(job, "elastic_ckpt", "manifest.json")
        assert os.path.exists(manifest), os.listdir(job)
        outs = W.Launch(job, "elastic_resume", n_resume).finish(TIMEOUT)
        rows = np.concatenate([o["rows"] for o in outs])
        assert sorted(rows.tolist()) == list(range(ref.M_rows))   # every row on one rank
        for r, o in enumerate(outs):
            np.testing.assert_allclose(o["trace"], ref_trace, rtol=RTOL)
            np.testing.assert_allclose(o["beta"], ref.beta.numpy(), rtol=RTOL, atol=1e-13)
            np.testing.assert_allclose(o["gamma"], np.asarray(ref.gamma)[o["rows"]], rtol=RTOL,
                                       atol=1e-13, err_msg=f"{n_save}->{n_resume} rank {r}")
