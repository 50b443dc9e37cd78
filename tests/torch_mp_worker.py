"""One process of the port's multi-process tests: a rank of a gloo group
on the CPU, in float64.

Launched by ``tests/test_torch_parallel.py`` and
``tests/test_torch_parallel_streaming.py`` as ``world`` OS processes.  It
imports no JAX (and checks that none was imported), and runs every case
of its mode in one launch, so process start-up is paid once:

* ``families``: ``kbn_psum`` on this rank's (hi, lo) parts; then each of
  the seven families from the JAX package's init on a mesh of ``world``
  devices (``init.npz``, carried in by ``convert.state_for``), trained
  ``ITERS`` iterations; then LDA's checkpoint directory written by every
  rank, loaded back at this world size and resumed one iteration;
* ``stream``: ``StreamingLDA`` and ``StreamingCTPF``, batch CAVI and
  online SVI, and a streaming checkpoint directory;
* ``one_rank``: on a group of one, ``kbn_psum`` and an LDA on the mesh of
  every rank against one with no collective, bit for bit.

Usage: python torch_mp_worker.py <rank> <world> <port> <job_dir> <mode>
Writes ``<job_dir>/out{rank}.npz``.
"""

import json
import os
import sys

import numpy as np

K, ITERS = 3, 3
RUNTIME = dict(chunk_docs=8, dtype="float64", pad_multiple=8)
FAMILIES = ("LDA", "fLDA", "CTPF", "CTM", "fCTM", "HMTM", "DTM")
STREAM = dict(batch_docs=32, chunk_docs=8, seed=3)


def corpora(pkg) -> dict:
    """Each family's corpus, built alike by either package (``pkg`` is
    ``topicmodelsvb_jl_tpu`` or ``topicmodelsvb_jl_torch``)."""
    base = dict(M=44, V=30, K=3, mean_terms=10, mean_tokens=16)
    out = {"LDA": pkg.synth_corpus(seed=5, **base),
           "fLDA": pkg.synth_corpus(seed=6, **base),
           "CTPF": pkg.synth_corpus(seed=7, U=12, mean_readers=3, **base),
           "CTM": pkg.synth_corpus(seed=8, **base),
           "fCTM": pkg.synth_corpus(seed=9, **base),
           "HMTM": pkg.synth_corpus(seed=10, **base),
           "DTM": pkg.synth_corpus(M=40, V=30, K=3, seed=6, n_slices=3, drift=0.3,
                                   mean_terms=18, mean_tokens=30)}
    pkg.expand_corp(out["HMTM"])   # HMTM reads the token order
    return out


def build(pkg, family, corp, runtime, **kw):
    """``family``'s model of ``pkg`` on ``corp`` (``kw``: ``mesh`` or
    ``device``)."""
    cls = getattr(pkg, family)
    if family == "DTM":
        return cls(corp, K, delta=1.0, runtime=runtime, seed=4, **kw)
    return cls(corp, K, runtime=runtime, seed=3, **kw)


def stream_packed(pkg):
    """The streaming runs' corpora: (LDA's, CTPF's with readers), dense."""
    corp = pkg.synth_corpus(M=90, V=40, U=16, K=3, seed=4, mean_terms=10, mean_readers=3)
    return (pkg.pack_corpus(corp, pad_multiple=8, docs_multiple=32, dtype=np.float64),
            pkg.pack_corpus(corp, pad_multiple=8, docs_multiple=32, with_readers=True,
                            dtype=np.float64))


def _families(tt, job, rank, world, out):
    import torch

    from topicmodelsvb_jl_torch import convert
    from topicmodelsvb_jl_torch.api import TopicModelError
    from topicmodelsvb_jl_torch.parallel import multihost
    from topicmodelsvb_jl_torch.parallel.mesh import make_mesh
    from topicmodelsvb_jl_torch.utils.numerics import kbn_psum

    init = np.load(os.path.join(job, "init.npz"))
    mesh = make_mesh()
    acc = tuple(torch.as_tensor(init[f"kbn/{p}"][rank]) for p in ("hi", "lo"))
    hi, lo = kbn_psum(acc, mesh, "data")
    out["kbn/hi"], out["kbn/lo"] = hi.numpy(), lo.numpy()
    out["doc_range"] = np.array(multihost.process_doc_range(101))

    corp = corpora(tt)
    rt = tt.RuntimeConfig(**RUNTIME)
    for fam in FAMILIES:
        m = build(tt, fam, corp[fam], rt, device="cpu")
        assert m.mesh.size() == world and m.local_packed.M_pad * world == m.packed.M_pad
        m.state = convert.state_for(m, {f: init[f"{fam}/{f}"] for f in m.state.__dataclass_fields__})
        m.train(iter=ITERS, checkelbo=1, printelbo=False)
        out[f"{fam}/trace"] = np.array([r.elbo for r in m.trainer.trace])
        for f in m.state.__dataclass_fields__:
            out[f"{fam}/{f}"] = getattr(m.state, f).numpy()
        if fam == "LDA":
            lda = m
    # a sharded model never passes its rows off as the whole
    for what in (lambda: lda.gamma, lambda: lda.topicdist(1)):
        try:
            what()
            raise AssertionError("a per-document accessor returned a slab")
        except TopicModelError:
            pass
    # LDA's checkpoint directory, written by every rank, loaded back here
    path = os.path.join(job, "ckpt_lda")
    tt.save_checkpoint(path, lda)
    back = tt.load_checkpoint(path, corp["LDA"], device="cpu")
    for f in lda.state.__dataclass_fields__:
        assert torch.equal(getattr(back.state, f), getattr(lda.state, f)), f
    assert back.trained_iters == lda.trained_iters == ITERS
    back.train(iter=1, checkelbo=1, printelbo=False)
    out["LDA/resumed_beta"] = back.state.beta.numpy()
    out["LDA/resumed_trace"] = np.array([r.elbo for r in back.trainer.trace])


def _stream(tt, job, rank, world, out):
    import torch

    pk_lda, pk_ctpf = stream_packed(tt)
    for name, pk in (("StreamingLDA", pk_lda), ("StreamingCTPF", pk_ctpf)):
        for mode in ("batch", "online"):
            m = getattr(tt, name)(pk, K, dtype=torch.float64, device="cpu", **STREAM)
            if mode == "batch":
                m.train(iter=ITERS, checkelbo=1, printelbo=False)
            else:
                m.train_online(epochs=2, checkelbo=1, printelbo=False, tau0=4.0)
            key = f"{name}/{mode}"
            out[f"{key}/trace"] = np.array([t[1] for t in m.trace])
            for n in m._globals:
                out[f"{key}/{n}"] = getattr(m, n).numpy()
            out[f"{key}/rows"] = m._local_to_global_rows(
                m.M_rows, m.batch_docs, m._batch_docs_global, rank)
            for n in m._doc_state:
                out[f"{key}/doc_{n}"] = np.asarray(getattr(m, n))
    # a checkpoint at iteration 2 of batch CAVI, then one more iteration
    m = tt.StreamingLDA(pk_lda, K, dtype=torch.float64, device="cpu", **STREAM)
    m.train(iter=2, checkelbo=1, printelbo=False)
    m.save(os.path.join(job, "stream_ckpt"))
    back = tt.load_streaming_checkpoint(os.path.join(job, "stream_ckpt"), pk_lda, device="cpu")
    for n in m._doc_state:
        assert np.array_equal(getattr(back, n), getattr(m, n)), n
    for n in m._globals:
        assert torch.equal(getattr(back, n), getattr(m, n)), n
    m.train(iter=1, checkelbo=1, printelbo=False)
    out["ckpt/beta3"] = m.beta.numpy()


def _one_rank(tt, job, rank, world, out):
    """On a one-rank group the reductions are the identity, bit for bit: a
    model on the mesh of every rank equals one with no collective."""
    import torch

    from topicmodelsvb_jl_torch.parallel import shard
    from topicmodelsvb_jl_torch.parallel.mesh import make_mesh
    from topicmodelsvb_jl_torch.utils.numerics import kbn_psum

    mesh = make_mesh()
    x = torch.tensor([1e8, -3.0, 2.5e-9], dtype=torch.float64)
    hi, lo = kbn_psum((x, x * 1e-17), mesh, "data")
    assert torch.equal(hi, x) and torch.equal(lo, x * 1e-17)
    corp = corpora(tt)["LDA"]
    rt = tt.RuntimeConfig(**RUNTIME)
    runs = {}
    for name, m in (("local", make_mesh(local=True)), ("group", mesh)):
        shard.STATS.reset()
        model = tt.LDA(corp, K, runtime=rt, mesh=m, device="cpu", seed=3)
        model.train(iter=2, checkelbo=1, printelbo=False)
        runs[name] = (model.state, shard.STATS.calls)
    assert runs["local"][1] == 0 and runs["group"][1] > 0, runs
    for f in runs["local"][0].__dataclass_fields__:
        assert torch.equal(getattr(runs["local"][0], f), getattr(runs["group"][0], f)), f
    out["calls"] = np.array(runs["group"][1])


def main():
    rank, world, port, job, mode = (int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
                                    sys.argv[4], sys.argv[5])
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from topicmodelsvb_jl_torch.parallel import multihost

    multihost.initialize(f"localhost:{port}", world, rank, backend="gloo")
    import topicmodelsvb_jl_torch as tt

    out = {}
    {"families": _families, "stream": _stream, "one_rank": _one_rank}[mode](
        tt, job, rank, world, out)
    bad = [m for m in sys.modules if m == "jax" or m.startswith(("jax.", "topicmodelsvb_jl_tpu"))]
    assert not bad, bad
    np.savez(os.path.join(job, f"out{rank}.npz"), **out)
    print(json.dumps({"rank": rank, "ok": True}))


if __name__ == "__main__":
    main()
