"""One process of the port's multi-process tests: a rank of a gloo group
on the CPU, in float64; and :class:`Launch`, which starts the ranks.

Launched by ``tests/test_torch_parallel.py``,
``tests/test_torch_parallel_streaming.py`` and ``tests/test_torch_tp.py``
as ``world`` OS processes.  It imports no JAX (and checks that none was
imported), and runs every case of its mode in one launch, so process
start-up is paid once:

* ``families``: ``kbn_psum`` on this rank's (hi, lo) parts; then each of
  the seven families from the JAX package's init on a mesh of ``world``
  devices (``init.npz``, carried in by ``convert.state_for``), trained
  ``ITERS`` iterations; then LDA's checkpoint directory written by every
  rank, loaded back at this world size and resumed one iteration;
* ``stream``: ``StreamingLDA`` and ``StreamingCTPF``, batch CAVI and
  online SVI, and a streaming checkpoint directory;
* ``elastic_save``/``elastic_resume``: a ``StreamingLDA`` trained
  :data:`ELASTIC_ITERS` iterations saves its checkpoint directory into
  the job directory; a group of any other size loads it, each rank its
  own rows, and trains :data:`ELASTIC_ITERS` more;
* ``one_rank``: on a group of one, ``kbn_psum`` and an LDA on the mesh of
  every rank against one with no collective, bit for bit;
* ``tp``: on four ranks, every case of :data:`TP_CASES` (tensor and
  sequence parallelism: the vocab, user and seq axes, routed LDA, the
  seq axis of LDA, fLDA, CTM, fCTM and CTPF, and StreamingLDA's vocab
  axis) from the JAX package's init (``init.npz``, each rank's blocks cut
  by ``convert.shard_state``), each case's whole state gathered onto
  every rank at the end.

Usage: python torch_mp_worker.py <rank> <world> <port> <job_dir> <mode>
Writes ``<job_dir>/out{rank}.npz``.  A rank whose rendezvous fails (the
port taken between its choice and rank 0's bind) exits with
:data:`RENDEZVOUS_EXIT`, and :class:`Launch` starts the group again on a
new port.
"""

import json
import os
import socket
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RENDEZVOUS_EXIT = 75   # the process group never formed: not a result

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
    return (pkg.ops.packing.pack_corpus(corp, pad_multiple=8, docs_multiple=32, dtype=np.float64),
            pkg.ops.packing.pack_corpus(corp, pad_multiple=8, docs_multiple=32, with_readers=True,
                            dtype=np.float64))


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


class Launch:
    """``world`` ranks of this worker in ``mode``, started on a free port.

    :meth:`finish` waits for them, polling: a rank that exits with
    :data:`RENDEZVOUS_EXIT` ends the attempt, and the group starts again
    on a new port (the chosen port can be taken by another process before
    rank 0 binds it); any other failure, or ``timeout`` seconds, ends the
    wait with every rank killed and the failing rank's log."""

    ATTEMPTS = 4

    def __init__(self, job: str, mode: str, world: int):
        self.job, self.mode, self.world = job, mode, world
        self.attempts = 0
        self._spawn()

    def _spawn(self) -> None:
        self.attempts += 1
        port = free_port()
        env = dict(os.environ, OMP_NUM_THREADS="1")
        self.logs = [os.path.join(self.job, f"rank{r}.log") for r in range(self.world)]
        self.procs = []
        for r in range(self.world):
            with open(self.logs[r], "w") as log:
                self.procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), str(r), str(self.world),
                     str(port), self.job, self.mode],
                    stdout=log, stderr=subprocess.STDOUT, cwd=ROOT, env=env))

    def _kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
            p.wait()

    def _log(self, r: int) -> str:
        with open(self.logs[r]) as f:
            return f.read()[-4000:]

    def finish(self, timeout: float) -> list:
        """Every rank's ``out{rank}.npz`` once all of them exit 0."""
        deadline = time.monotonic() + timeout
        try:
            while True:
                codes = [p.poll() for p in self.procs]
                if RENDEZVOUS_EXIT in codes and self.attempts < self.ATTEMPTS:
                    self._kill()
                    self._spawn()
                    continue
                bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
                assert not bad, f"worker {bad[0]} failed:\n{self._log(bad[0])}"
                if all(c == 0 for c in codes):
                    break
                assert time.monotonic() < deadline, f"workers timed out after {timeout} s"
                time.sleep(0.05)
        finally:
            self._kill()
        return [dict(np.load(os.path.join(self.job, f"out{r}.npz")))
                for r in range(self.world)]


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


# ── elastic restore (modes "elastic_save" and "elastic_resume") ──
ELASTIC_ITERS = 2


def _elastic_save(tt, job, rank, world, out):
    import torch

    m = tt.StreamingLDA(stream_packed(tt)[0], K, dtype=torch.float64, device="cpu", **STREAM)
    m.train(iter=ELASTIC_ITERS, tol=0.0, checkelbo=1, printelbo=False)
    m.save(os.path.join(job, "elastic_ckpt"))
    out["trace"] = np.array([t[1] for t in m.trace])


def _elastic_resume(tt, job, rank, world, out):
    m = tt.load_streaming_checkpoint(os.path.join(job, "elastic_ckpt"), stream_packed(tt)[0],
                                     device="cpu")
    assert m._nproc == world and m.trained_iters == ELASTIC_ITERS
    m.train(iter=ELASTIC_ITERS, tol=0.0, checkelbo=1, printelbo=False)
    out["trace"] = np.array([t[1] for t in m.trace])
    out["beta"] = m.beta.numpy()
    out["rows"] = m._local_to_global_rows(m.M_rows, m.batch_docs, m._batch_docs_global, rank)
    out["gamma"] = np.asarray(m.gamma)


# ── tensor and sequence parallelism (mode "tp", four ranks) ──
TP_WORLD, TP_K, TP_ITERS = 4, 4, 3
TP_STEP = dict(viter=5, niter=100)   # vtol = ntol = 1/K²
DV = dict(axes=("data", "vocab"), shape=(2, 2), doc=("data", "vocab"), vocab="vocab")
DS = dict(axes=("data", "seq"), shape=(2, 2), doc=("data",), seq="seq")
# each case: its family, mesh, the axes its documents shard over, and its
# modes (every mesh names its axes in the order JAX's PartitionSpecs do)
TP_CASES = {
    "LDA_vocab": dict(family="LDA", chunk=8, **DV),
    "LDA_routed": dict(family="LDA", chunk=16, axes=("data", "vocab"), shape=(2, 2),
                       doc=("data",), vocab="vocab", routed=True),
    "LDA_seq": dict(family="LDA", chunk=16, axes=("data", "seq"), shape=(2, 2),
                    doc=("data",), seq="seq"),
    "LDA_3d": dict(family="LDA", chunk=16, axes=("data", "vocab", "seq"), shape=(1, 2, 2),
                   doc=("data", "vocab"), vocab="vocab", seq="seq"),
    "fLDA_vocab": dict(family="fLDA", chunk=4, **DV),
    "fLDA_seq": dict(family="fLDA", chunk=4, **DS),
    # kappa's statistic is vocab-sharded and token-level at once here
    "fLDA_3d": dict(family="fLDA", chunk=4, axes=("data", "vocab", "seq"), shape=(1, 2, 2),
                    doc=("data", "vocab"), vocab="vocab", seq="seq"),
    "CTM_vocab": dict(family="CTM", chunk=4, **DV),
    "CTM_seq": dict(family="CTM", chunk=4, **DS),
    "fCTM_vocab": dict(family="fCTM", chunk=4, **DV),
    "fCTM_seq": dict(family="fCTM", chunk=4, **DS),
    "CTPF_vocab_user": dict(family="CTPF", chunk=4, axes=("data", "vocab", "user"),
                            shape=(1, 2, 2), doc=("data", "vocab", "user"), vocab="vocab",
                            user="user"),
    # both ragged axes, the token slots and the reader slots, over seq
    "CTPF_seq": dict(family="CTPF", chunk=4, **DS),
    "DTM_vocab": dict(family="DTM", chunk=4, **DV),
    "HMTM_vocab": dict(family="HMTM", chunk=4, **DV),
    "StreamingLDA_vocab": dict(family="StreamingLDA", chunk=8, **DV),
}
DTM_T = 3
DTM_CG = dict(cgiter=4, cgtol=1e-9)


def dense(pkg, M: int, V: int, L: int, seed: int):
    """A dense packed corpus of ragged random documents (either package's
    PackedCorpus, built from the same numpy draws)."""
    rng = np.random.default_rng(seed)
    terms = rng.integers(0, V, size=(M, L)).astype(np.int32)
    counts = (1 + rng.poisson(0.4, size=(M, L))).astype(np.float64)
    n = rng.integers(4, L, size=M)
    valid = np.arange(L)[None, :] < n[:, None]
    counts *= valid
    terms *= valid
    return pkg.ops.packing.PackedCorpus(
        terms=terms, counts=counts, doc_mask=np.ones(M, np.float64), N=n.astype(np.int32),
        C=counts.sum(1), M=M, V=V, L=L, max_count=int(counts.max()))


def tp_corpus(pkg, case: str):
    """The case's whole corpus (and for DTM its [M_pad] slice ids), built
    alike by either package."""
    fam = TP_CASES[case]["family"]
    if fam == "LDA":
        packed = dense(pkg, 64, 64, 16, 0)
        if TP_CASES[case].get("routed"):
            packed = pkg.route_packed(packed, n_shards=2, pad_multiple=8)
        return packed, None
    if fam in ("fLDA", "CTM", "fCTM"):
        return dense(pkg, 32, 64, 16, {"fLDA": 7, "CTM": 4, "fCTM": 8}[fam]), None
    if fam == "HMTM":
        return pkg.ops.packing.unit_counts(dense(pkg, 32, 64, 16, 1)), None
    if fam == "CTPF":
        corp = pkg.synth_corpus(M=32, V=64, K=3, U=16, seed=6, mean_terms=10, mean_tokens=16)
        return pkg.ops.packing.pack_corpus(corp, pad_multiple=8, docs_multiple=8, with_readers=True,
                               dtype=np.float64), None
    if fam == "DTM":
        corp = pkg.synth_corpus(M=32, V=64, K=3, seed=9, n_slices=DTM_T, drift=0.2,
                                mean_terms=10, mean_tokens=16)
        packed = pkg.ops.packing.pack_corpus(corp, pad_multiple=8, docs_multiple=8, dtype=np.float64)
        stamps = np.array([d.stamp for d in corp.docs])
        sid = np.clip(np.ceil(stamps - stamps.min()).astype(np.int64), 1, DTM_T) - 1
        slice_id = np.zeros(packed.M_pad, dtype=np.int64)
        slice_id[:packed.M] = sid
        return packed, slice_id
    return stream_packed(pkg)[0], None   # StreamingLDA


def _tp_run(tt, case, init, mesh, out):
    """Train ``case`` on this rank from the JAX init; record each
    iteration's bound and the whole state gathered at the end."""
    import torch

    from topicmodelsvb_jl_torch import convert
    from topicmodelsvb_jl_torch.models import ctm, ctpf, dtm, fctm, flda, hmtm, lda
    from topicmodelsvb_jl_torch.parallel.mesh import local_block
    from topicmodelsvb_jl_torch.parallel.multihost import local_slab
    from topicmodelsvb_jl_torch.parallel.shard import all_gather
    from topicmodelsvb_jl_torch.utils.numerics import elbo_value

    c = TP_CASES[case]
    fam, K, f64 = c["family"], TP_K, torch.float64
    doc, vocab, seq, user = c["doc"], c.get("vocab"), c.get("seq"), c.get("user")
    routed = c.get("routed", False)
    packed, slice_id = tp_corpus(tt, case)
    if fam == "StreamingLDA":
        m = tt.StreamingLDA(packed, K, dtype=f64, device="cpu", mesh=mesh, vocab_axis=vocab,
                            **STREAM)
        for n in m._globals:   # the JAX init, this rank's vocab block of beta
            x = init[f"{case}/{n}"]
            x = local_block(x, mesh, vocab, dim=1) if n != "alpha" else x
            setattr(m, n, torch.tensor(np.array(x), dtype=f64))
        m.train(iter=TP_ITERS, checkelbo=1, printelbo=False)
        out[f"{case}/trace"] = np.array([t[1] for t in m.trace])
        for n in m._globals:
            x = getattr(m, n)
            out[f"{case}/{n}"] = (all_gather(x, mesh, vocab, dim=1) if n != "alpha"
                                  else x).numpy()
        out[f"{case}/rows"] = m._local_to_global_rows(m.M_rows, m.batch_docs,
                                                     m._batch_docs_global, m._pid)
        for n in m._doc_state:
            out[f"{case}/doc_{n}"] = np.asarray(getattr(m, n))
        return
    slab = local_slab(packed, mesh, doc, vocab if routed else seq)
    put = lambda a, dt: torch.as_tensor(np.asarray(a), dtype=dt)
    t, cnt, dm = put(slab.terms, torch.int32), put(slab.counts, f64), put(slab.doc_mask, f64)
    vtol = ntol = 1.0 / K ** 2
    kw = dict(mesh=mesh, axis_name=doc, vocab_axis=vocab)
    if seq is not None:
        kw.update(seq_axis=seq)
    common = dict(viter=TP_STEP["viter"], vtol=vtol, niter=TP_STEP["niter"], ntol=ntol,
                  chunk_docs=c["chunk"], device="cpu")
    if fam == "LDA":
        kw.update(vocab_routed=routed)
        step = lda.make_step(slab, K, **common, **kw)
        elbo = lda.make_elbo(slab, K, c["chunk"], **kw)
        args, eargs = (t, cnt, dm, float(packed.M)), (t, cnt, dm)
    elif fam in ("fLDA", "CTM", "fCTM", "HMTM"):
        mod = {"fLDA": flda, "CTM": ctm, "fCTM": fctm, "HMTM": hmtm}[fam]
        step = mod.make_step(slab, K, **common, **kw)
        elbo = mod.make_elbo(slab, K, c["chunk"], **kw)
        args = (t, cnt, dm, float(packed.M))
        if fam == "fLDA":
            args = (t, cnt, dm, torch.tensor(float(packed.M), dtype=f64),
                    torch.tensor(float(packed.C.sum()), dtype=f64))
        eargs = (t, cnt, dm)
    elif fam == "CTPF":
        kw.update(user_axis=user)
        step = ctpf.make_step(slab, K, viter=common["viter"], vtol=vtol,
                              chunk_docs=c["chunk"], device="cpu", **kw)
        elbo = ctpf.make_elbo(slab, K, c["chunk"], **kw)
        args = eargs = (t, cnt, put(slab.readers, torch.int32), put(slab.ratings, f64), dm)
    else:   # DTM
        sid = np.ascontiguousarray(local_block(slice_id, mesh, doc))
        step = dtm.make_step(slab, K, DTM_T, **common, **DTM_CG, slice_id=sid, **kw)
        elbo = dtm.make_elbo(slab, K, DTM_T, c["chunk"], **kw)
        args = eargs = (torch.as_tensor(sid), t, cnt, dm)
    cls = {"LDA": lda.LDAState, "fLDA": flda.FLDAState, "CTM": ctm.CTMState,
           "fCTM": fctm.FCTMState, "CTPF": ctpf.CTPFState, "DTM": dtm.DTMState,
           "HMTM": hmtm.HMTMState}[fam]
    state = convert.shard_state(cls, {f: init[f"{case}/{f}"] for f in cls.__dataclass_fields__},
                                mesh, data_axis=doc, vocab_axis=vocab, user_axis=user,
                                seq_axis=seq, dtype=f64)
    trace = []
    for _ in range(TP_ITERS):
        state = step(state, *args)
        trace.append(elbo_value(elbo(state, *eargs)))
    out[f"{case}/trace"] = np.array(trace)
    lay = convert.LAYOUT[cls]
    for f in cls.__dataclass_fields__:
        x = getattr(state, f)
        if f in lay["doc"]:
            x = all_gather(x, mesh, doc, dim=0)
        for key, axis in (("vocab", vocab), ("user", user), ("seq", seq)):
            if axis is not None and f in lay.get(key, {}):
                x = all_gather(x, mesh, axis, dim=lay[key][f])
        out[f"{case}/{f}"] = x.numpy()


def _tp(tt, job, rank, world, out):
    from topicmodelsvb_jl_torch.parallel.mesh import make_mesh

    init = np.load(os.path.join(job, "init.npz"))
    meshes = {}
    for case, c in TP_CASES.items():
        key = (c["axes"], c["shape"])
        if key not in meshes:   # every rank builds the meshes in one order
            meshes[key] = make_mesh(axis_names=c["axes"], shape=c["shape"])
        _tp_run(tt, case, init, meshes[key], out)
    # an api model on a data × vocab mesh: sharded over the data axis,
    # replicated over the vocab axis, as the JAX package's api shards
    from topicmodelsvb_jl_torch import convert
    from topicmodelsvb_jl_torch.parallel.shard import all_gather

    mesh = meshes[(("data", "vocab"), (2, 2))]
    m = build(tt, "LDA", corpora(tt)["LDA"], tt.RuntimeConfig(**RUNTIME), device="cpu",
              mesh=mesh)
    out["api/n_shards"], out["api/replica"] = np.array(m._n_shards), np.array(m._replica)
    m.state = convert.state_for(m, {f: init[f"api/{f}"] for f in m.state.__dataclass_fields__})
    m.train(iter=ITERS, checkelbo=1, printelbo=False)
    out["api/trace"] = np.array([r.elbo for r in m.trainer.trace])
    for f in m.state.__dataclass_fields__:
        out[f"api/{f}"] = getattr(m.state, f).numpy()
    tt.save_checkpoint(os.path.join(job, "ckpt_api"), m)


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

    try:
        multihost.initialize(f"localhost:{port}", world, rank, backend="gloo")
    except Exception as e:   # the rendezvous, not a result: Launch retries
        print(f"rendezvous failed: {e!r}", file=sys.stderr)
        sys.exit(RENDEZVOUS_EXIT)
    import topicmodelsvb_jl_torch as tt

    out = {}
    {"families": _families, "stream": _stream, "one_rank": _one_rank, "tp": _tp,
     "elastic_save": _elastic_save, "elastic_resume": _elastic_resume}[mode](
        tt, job, rank, world, out)
    bad = [m for m in sys.modules if m == "jax" or m.startswith(("jax.", "topicmodelsvb_jl_tpu"))]
    assert not bad, bad
    np.savez(os.path.join(job, f"out{rank}.npz"), **out)
    print(json.dumps({"rank": rank, "ok": True}))


if __name__ == "__main__":
    main()
