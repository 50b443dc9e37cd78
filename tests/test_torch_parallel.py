"""The port's data axis across processes (``topicmodelsvb_jl_torch/parallel``)
against the JAX package on a mesh of as many devices, on the CPU in f64.

Two OS processes of a gloo group (``tests/torch_mp_worker.py``, no JAX)
train each of the seven families from the JAX package's init on
``make_mesh(n_devices=2)`` while this process trains the JAX models.  Each
iteration's bound and the final state follow JAX to 1e-8 relative (the
port's standing parity tolerance), and the two ranks agree bit for bit on
every global and on the bound.  ``kbn_psum`` over the two ranks equals
JAX's on two devices bit for bit.  LDA's checkpoint directory, written by
both ranks, loads in the JAX package and in the port at one and at two
processes.  A third process, a group of one, shows the reductions are the
identity there, bit for bit.
"""

import os

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import topicmodelsvb_jl_tpu as tm
from topicmodelsvb_jl_tpu.parallel.mesh import make_mesh as jax_make_mesh
from topicmodelsvb_jl_tpu.parallel.shard import shard_map
from topicmodelsvb_jl_tpu.utils.config import RuntimeConfig as JaxRuntimeConfig
from topicmodelsvb_jl_tpu.utils.numerics import kbn_psum as jax_kbn_psum
import topicmodelsvb_jl_torch as tt
from topicmodelsvb_jl_torch.api import TopicModelError
from topicmodelsvb_jl_torch.parallel import mesh as pmesh
from topicmodelsvb_jl_torch.parallel import multihost

import torch_mp_worker as W

WORLD, TIMEOUT = 2, 300
RTOL = 1e-8


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX models on two devices and the port's two ranks, from one
    init; the one-rank group's run beside them."""
    job = str(tmp_path_factory.mktemp("parallel"))
    one = str(tmp_path_factory.mktemp("one_rank"))
    corp = W.corpora(tm)
    mesh = jax_make_mesh(n_devices=WORLD)
    rt = JaxRuntimeConfig(**W.RUNTIME)
    jms, init = {}, {}
    for fam in W.FAMILIES:
        jms[fam] = W.build(tm, fam, corp[fam], rt, mesh=mesh)
        init.update({f"{fam}/{f}": np.asarray(v) for f, v in jms[fam].state._asdict().items()})
    rng = np.random.default_rng(0)
    init["kbn/hi"] = rng.standard_normal((WORLD, 6)) * np.array([1e8, 1.0, 1e-8, 3e4, 1e12, 7.0])
    init["kbn/lo"] = rng.standard_normal((WORLD, 6)) * 1e-9
    np.savez(os.path.join(job, "init.npz"), **init)
    launches = (W.Launch(job, "families", WORLD), W.Launch(one, "one_rank", 1))
    try:
        for fam in W.FAMILIES:
            jms[fam].train(iter=W.ITERS, checkelbo=1, printelbo=False)
        f = jax.jit(shard_map(lambda h, lo: jax_kbn_psum((h[0], lo[0]), ("data",)), mesh=mesh,
                              in_specs=(P("data"), P("data")), out_specs=P(),
                              check_vma=False))
        jkbn = [np.asarray(x) for x in f(init["kbn/hi"], init["kbn/lo"])]
    finally:
        outs = launches[0].finish(TIMEOUT)
        one_out = launches[1].finish(TIMEOUT)
    return dict(jax=jms, corp=corp, outs=outs, one=one_out[0], jkbn=jkbn, job=job)


def test_process_doc_range_and_mesh_shapes():
    assert (multihost.process_count(), multihost.process_index()) == (1, 0)
    assert multihost.process_doc_range(101) == (0, 101)
    m = pmesh.make_mesh(axis_names=("data", "vocab"))
    assert isinstance(m, pmesh.LocalMesh) and m.shape == (1, 1) and m.size() == 1
    assert pmesh.axis_size(m, "data") == 1 and pmesh.axis_index(None, "data") == 0
    assert pmesh.make_mesh(local=True).mesh_dim_names == ("data",)
    a = np.arange(12).reshape(6, 2)
    np.testing.assert_array_equal(multihost.local_rows(a, 3, 1), a[2:4])
    with pytest.raises(ValueError, match="process group of 2"):
        pmesh.make_mesh(n_devices=2)
    with pytest.raises(ValueError, match="divide"):
        multihost.local_rows(a, 4, 0)


def test_worker_doc_range_and_one_rank_identity(runs):
    np.testing.assert_array_equal(runs["outs"][1]["doc_range"], [51, 101])
    np.testing.assert_array_equal(runs["outs"][0]["doc_range"], [0, 51])
    assert int(runs["one"]["calls"]) > 0   # the group run made its collectives


def test_tensor_parallel_axes_are_refused():
    """Since the vocab and sequence axes are ported this holds what the
    port accepts, as the JAX package does, and what it refuses as the JAX
    package does: an N-D mesh needs a process group of its size; a
    RuntimeConfig's tensor-parallel mesh_shape leaves the api model on the
    data axis (the JAX package's api never reads it), bit for bit the
    model without it; the sequence axis of fLDA, CTM, fCTM and CTPF on a
    length-bucketed corpus raises ``ValueError`` in every ``make_step``
    and ``make_elbo`` (JAX's assert: a split token axis needs dense
    packing)."""
    from topicmodelsvb_jl_torch.models import ctm, ctpf, fctm, flda

    with pytest.raises(ValueError, match="process group of 2"):
        pmesh.make_mesh(shape=(1, 2), axis_names=("data", "vocab"))
    assert pmesh.make_mesh(axis_names=("data", "vocab", "seq")).shape == (1, 1, 1)
    corp = tt.synth_corpus(M=20, V=15, K=2, seed=1)
    tp, plain = (tt.LDA(corp, 2, tt.RuntimeConfig(**kw), device="cpu", seed=1)
                 for kw in (dict(mesh_shape=(1, 2)), {}))
    for m in (tp, plain):
        m.train(iter=2, checkelbo=1, printelbo=False)
    assert tp._n_shards == 1 and tp._replica == 0
    for f in tp.state.__dataclass_fields__:
        assert torch.equal(getattr(tp.state, f), getattr(plain.state, f)), f
    with pytest.raises(ValueError, match="process group"):
        tt.LDA(corp, 2, tt.RuntimeConfig(mesh_shape=(2,)), device="cpu")
    pmesh.check_axes(_FakeMesh(), "data", ("vocab",), None)
    with pytest.raises(ValueError, match="no axis 'seq'"):
        pmesh.check_axes(_FakeMesh(), "seq")
    pk = tt.bucketize_packed(tt.pack_corpus(corp, pad_multiple=8, docs_multiple=8,
                                            dtype=np.float64), chunk=8, pad_multiple=8)
    assert pk.segments is not None
    kw = dict(viter=2, vtol=0.1, niter=2, ntol=0.1, chunk_docs=8, device="cpu", seq_axis="seq")
    makers = [lambda m=m: m.make_step(pk, 2, **kw) for m in (flda, ctm, fctm)]
    makers.append(lambda: ctpf.make_step(pk, 2, viter=2, vtol=0.1, chunk_docs=8, device="cpu",
                                         seq_axis="seq"))
    makers += [lambda m=m: m.make_elbo(pk, 2, 8, seq_axis="seq") for m in (flda, ctm, fctm, ctpf)]
    for make in makers:
        with pytest.raises(ValueError, match="dense packing"):
            make()


class _FakeMesh:
    """A mesh of a data and a vocab axis, 1 × 2."""

    mesh_dim_names = ("data", "vocab")

    def size(self, i=None):
        return (1, 2)[i] if i is not None else 2


def test_kbn_psum_matches_jax_bitwise(runs):
    o0, o1 = runs["outs"]
    for x in ("hi", "lo"):
        np.testing.assert_array_equal(o0[f"kbn/{x}"], o1[f"kbn/{x}"])
    np.testing.assert_array_equal(o0["kbn/hi"], runs["jkbn"][0])
    np.testing.assert_array_equal(o0["kbn/lo"], runs["jkbn"][1])


@pytest.mark.parametrize("family", W.FAMILIES)
def test_family_on_two_ranks_matches_jax_on_two_devices(runs, family):
    jm, (o0, o1) = runs["jax"][family], runs["outs"]
    per_doc = set(tt.api.__dict__[family]._per_doc_fields)
    jtrace = [r.elbo for r in jm.trainer.trace]
    assert len(jtrace) == W.ITERS
    np.testing.assert_array_equal(o0[f"{family}/trace"], o1[f"{family}/trace"])
    np.testing.assert_allclose(o0[f"{family}/trace"], jtrace, rtol=RTOL)
    for f, v in jm.state._asdict().items():
        want = np.asarray(v)
        if f in per_doc:
            got = np.concatenate([o0[f"{family}/{f}"], o1[f"{family}/{f}"]])
        else:
            np.testing.assert_array_equal(o0[f"{family}/{f}"], o1[f"{family}/{f}"],
                                          err_msg=f"ranks differ on {f}")
            got = o0[f"{family}/{f}"]
        if f == "elbo":   # a (hi, lo) pair: its value
            got, want = got.sum(), want.sum()
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-12, err_msg=f"{family} {f}")


def test_two_rank_checkpoint_loads_in_jax_and_in_one_process(runs):
    """The directory both ranks wrote: the JAX package's loader and the
    port's at one process read the same per-document state and globals;
    a resume of one iteration at one process follows the two-rank one."""
    path = os.path.join(runs["job"], "ckpt_lda")
    assert sorted(os.listdir(path)) == ["manifest.json", "proc0.npz", "proc1.npz"]
    o0, o1 = runs["outs"]
    jm = tm.load_checkpoint(path, runs["corp"]["LDA"])
    pm = tt.load_checkpoint(path, W.corpora(tt)["LDA"], device="cpu")
    assert pm.trained_iters == jm.trained_iters == W.ITERS and pm._n_shards == 1
    two = runs["jax"]["LDA"]   # the two-device JAX model holds the same layout
    rows = two._doc_rows()
    gamma = np.concatenate([o0["LDA/gamma"], o1["LDA/gamma"]])[rows]
    np.testing.assert_array_equal(pm.gamma, gamma)
    np.testing.assert_array_equal(np.asarray(jm.gamma), gamma)
    for f in ("alpha", "beta"):
        np.testing.assert_array_equal(getattr(pm, f), o0[f"LDA/{f}"])
        np.testing.assert_array_equal(np.asarray(getattr(jm, f)), o0[f"LDA/{f}"])
    pm.train(iter=1, checkelbo=1, printelbo=False)
    np.testing.assert_allclose(pm.beta, o0["LDA/resumed_beta"], rtol=RTOL, atol=1e-12)
    np.testing.assert_allclose([r.elbo for r in pm.trainer.trace], o0["LDA/resumed_trace"],
                               rtol=RTOL)
    np.testing.assert_array_equal(o0["LDA/resumed_beta"], o1["LDA/resumed_beta"])


def test_jax_checkpoint_mesh_shape_data_axis_loads_and_tensor_parallel_is_refused(tmp_path):
    """A JAX checkpoint loads whatever its mesh_shape: the data axis's, and
    since the vocab axis is ported a tensor-parallel one too (the JAX
    package never reads the field when it builds its mesh; the loading
    run's mesh is its own)."""
    corp = tm.synth_corpus(M=30, V=20, K=2, seed=2)
    jm = tm.LDA(corp, 2, runtime=JaxRuntimeConfig(chunk_docs=8, dtype="float64",
                                                  mesh_shape=(2,)),
                mesh=jax_make_mesh(n_devices=2), seed=1)
    jm.train(iter=1, checkelbo=1, printelbo=False)
    path = str(tmp_path / "jax.npz")
    tm.save_checkpoint(path, jm)
    pm = tt.load_checkpoint(path, tt.synth_corpus(M=30, V=20, K=2, seed=2), device="cpu")
    assert pm.runtime.mesh_shape is None and pm.runtime.data_axis == "data"
    np.testing.assert_array_equal(pm.gamma, np.asarray(jm.gamma))
    for shape in ([2, 2], [1, 2, 2]):
        tp = _rewrite(path, str(tmp_path / f"tp{len(shape)}.npz"), shape)
        pt = tt.load_checkpoint(tp, tt.synth_corpus(M=30, V=20, K=2, seed=2), device="cpu")
        assert pt.runtime.mesh_shape is None and pt.trained_iters == jm.trained_iters
        np.testing.assert_array_equal(pt.gamma, np.asarray(jm.gamma))
        np.testing.assert_array_equal(pt.beta, np.asarray(jm.beta))


def _rewrite(src, dst, mesh_shape):
    import json

    with np.load(src) as z:
        arrays = dict(z)
    meta = json.loads(bytes(arrays.pop("__meta__")).decode())
    meta["runtime"]["mesh_shape"] = mesh_shape
    with open(dst, "wb") as f:
        np.savez(f, __meta__=np.frombuffer(json.dumps(meta).encode(), np.uint8), **arrays)
    return dst


def test_launch_starts_again_when_the_rendezvous_port_is_taken(tmp_path, monkeypatch):
    """A port taken between its choice and rank 0's bind loses the
    rendezvous, not a result: the launch starts again on a new port."""
    import socket

    held = socket.socket()
    held.bind(("localhost", 0))
    held.listen(1)
    taken, real = held.getsockname()[1], W.free_port
    ports = iter([taken])
    monkeypatch.setattr(W, "free_port", lambda: next(ports, None) or real())
    try:
        launch = W.Launch(str(tmp_path), "one_rank", 1)
        out = launch.finish(TIMEOUT)
    finally:
        held.close()
    assert launch.attempts == 2 and int(out[0]["calls"]) > 0
    with open(os.path.join(str(tmp_path), "rank0.log")) as f:
        assert "rendezvous failed" not in f.read()   # the second attempt's log


def test_sharded_accessors_raise_on_a_local_slab():
    """A model of one shard reads every row; the guard names the way out."""
    m = tt.LDA(tt.synth_corpus(M=20, V=15, K=2, seed=1), 2, device="cpu")
    assert m.gamma.shape == (20, 2)
    m._n_shards = 2
    with pytest.raises(TopicModelError, match="save_checkpoint"):
        m.gamma
    with pytest.raises(TopicModelError, match="sharded"):
        m.topicdist(1)
