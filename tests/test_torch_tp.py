"""The port's tensor and sequence parallelism against the JAX package, on
the CPU in f64.

One launch of four gloo ranks (``tests/torch_mp_worker.py``, mode ``tp``,
no JAX) runs every case of ``TP_CASES`` while this process runs the JAX
package on a virtual mesh of the same shape: beta's (and kappa's) storage
over a vocab axis for LDA, fLDA, CTM, fCTM, DTM, HMTM and StreamingLDA,
CTPF's alef over vocab and he over users, routed LDA, the sequence axis
of LDA, fLDA, CTM, fCTM and CTPF (its token and reader slots), and LDA's
and fLDA's data × vocab × seq mesh.  CTPF, DTM and HMTM run JAX on one
device (its own tests hold its mesh runs to that, CTPF's sequence axis
included, tests/test_parallel.py's
``test_ctpf_seq_axis_sp_matches_single_device``, and they are its slow
tests).  Both packages start from the JAX init (``convert.shard_state``
cuts each rank's blocks); each iteration's bound and the final state
follow JAX to 1e-8 relative, and every rank holds the same bits of every
global and of the bound.  An api LDA on a data × vocab mesh shards over
the data axis alone and replicates across the vocab axis, as the JAX
package's does, and its checkpoint directory loads in both packages.

Also here: ``route_packed`` byte-identical to JAX's, the ``ValueError``
of ``save_packed``/``trim_packed`` on a RoutedCorpus, the pass mode
of the LDA E-step driven as a fixpoint with no collective against
``lda_estep_ref``, and ``local_slab`` cutting CTPF's reader slots with
its token slots.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import topicmodelsvb_jl_tpu as tm
from topicmodelsvb_jl_tpu import streaming as jst
from topicmodelsvb_jl_tpu.models import ctm as jctm
from topicmodelsvb_jl_tpu.models import ctpf as jctpf
from topicmodelsvb_jl_tpu.models import dtm as jdtm
from topicmodelsvb_jl_tpu.models import fctm as jfctm
from topicmodelsvb_jl_tpu.models import flda as jflda
from topicmodelsvb_jl_tpu.models import hmtm as jhmtm
from topicmodelsvb_jl_tpu.models import lda as jlda
from topicmodelsvb_jl_tpu.ops import packing as jpk
from topicmodelsvb_jl_tpu.parallel.mesh import make_mesh as jax_make_mesh
from topicmodelsvb_jl_tpu.parallel.shard import shard_map
from topicmodelsvb_jl_tpu.utils.config import RuntimeConfig as JaxRuntimeConfig
from topicmodelsvb_jl_tpu.utils.numerics import elbo_value
import topicmodelsvb_jl_torch as tt
from topicmodelsvb_jl_torch.kernels.lda_estep import (
    lda_estep_pass, lda_estep_pass_ref, lda_estep_ref, split_fixpoint,
)

import torch_mp_worker as W

RTOL, TIMEOUT = 1e-8, 400
API_MESH = dict(axis_names=("data", "vocab"), shape=(2, 2))
F64 = jnp.float64


def _jmesh(c):
    return jax_make_mesh(n_devices=int(np.prod(c["shape"])), axis_names=c["axes"],
                         shape=c["shape"])


def _smap(fn, mesh, in_specs, out_specs):
    return jax.jit(shard_map(fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                             check_vma=False))


def jax_case(case: str):
    """``case`` in the JAX package: (its init state, a function training it
    ``TP_ITERS`` iterations that returns (trace, final state arrays))."""
    c = W.TP_CASES[case]
    fam, K = c["family"], W.TP_K
    packed, slice_id = W.tp_corpus(tm, case)
    tol = 1.0 / K ** 2
    kw = dict(viter=W.TP_STEP["viter"], vtol=tol, niter=W.TP_STEP["niter"], ntol=tol)
    key = jax.random.PRNGKey(0)
    if fam == "StreamingLDA":
        m = jst.StreamingLDA(packed, K, dtype=F64, mesh=_jmesh(c), vocab_axis=c["vocab"], **W.STREAM)
        init = {n: np.asarray(getattr(m, n)) for n in m._globals}

        def run():
            m.train(iter=W.TP_ITERS, checkelbo=1, printelbo=False)
            out = {n: np.asarray(getattr(m, n)) for n in m._globals}
            out.update({f"doc_{n}": np.asarray(getattr(m, n)) for n in m._doc_state})
            return [t[1] for t in m.trace], out
        return init, run

    M = jnp.asarray(float(packed.M), F64)
    tok = (jnp.asarray(packed.terms), jnp.asarray(packed.counts))
    dm = jnp.asarray(packed.doc_mask)
    if fam == "LDA":
        state = jlda.init(key, packed, K, F64)
        mesh = _jmesh(c)
        doc = c["doc"] if len(c["doc"]) > 1 else c["doc"][0]
        spec = jlda.partition_spec(data_axis=doc, vocab_axis=c.get("vocab"))
        tokspec = P(doc, c["vocab"]) if c.get("routed") else (
            P(doc, c["seq"]) if c.get("seq") else P(doc))
        modes = dict(vocab_axis=c.get("vocab"), seq_axis=c.get("seq"),
                     vocab_routed=c.get("routed", False))
        step = _smap(jlda.make_step(packed, K, chunk_docs=c["chunk"], axis_name=doc,
                                    use_pallas=False, **kw, **modes),
                     mesh, (spec, tokspec, tokspec, P(doc), P()), spec)
        elbo = _smap(jlda.make_elbo(packed, K, chunk_docs=c["chunk"], axis_name=doc,
                                    **modes), mesh, (spec, tokspec, tokspec, P(doc)), P())
        args, eargs = (*tok, dm, M), (*tok, dm)
    elif fam in ("fLDA", "CTM", "fCTM"):
        mod = {"fLDA": jflda, "CTM": jctm, "fCTM": jfctm}[fam]
        state = mod.init(key, packed, K, F64)
        mesh = _jmesh(c)
        axes, d, seq = c["doc"], P(c["doc"]), c.get("seq")
        tokspec = P(axes, seq) if seq else d
        modes = dict(vocab_axis=c.get("vocab"), seq_axis=seq)
        spec = mod.partition_spec(data_axis=axes, **(modes if fam != "CTM" else
                                                     dict(vocab_axis=c.get("vocab"))))
        extra = dict(use_pallas=False) if fam == "fLDA" else {}
        args = (*tok, dm, M)
        scal = (P(),)
        if fam == "fLDA":
            args += (jnp.asarray(float(packed.C.sum()), F64),)
            scal = (P(), P())
        step = _smap(mod.make_step(packed, K, chunk_docs=c["chunk"], axis_name=axes,
                                   **modes, **kw, **extra),
                     mesh, (spec, tokspec, tokspec, d) + scal, spec)
        elbo = _smap(mod.make_elbo(packed, K, chunk_docs=c["chunk"], axis_name=axes,
                                   **modes), mesh, (spec, tokspec, tokspec, d), P())
        eargs = (*tok, dm)
    elif fam == "CTPF":
        state = jctpf.init(key, packed, K, F64)
        step = jax.jit(jctpf.make_step(packed, K, viter=kw["viter"], vtol=tol, chunk_docs=8,
                                       axis_name=None, use_pallas=False))
        elbo = jax.jit(jctpf.make_elbo(packed, K, chunk_docs=8))
        args = eargs = (*tok, jnp.asarray(packed.readers), jnp.asarray(packed.ratings), dm)
    elif fam == "DTM":
        state = jdtm.init(key, packed, K, W.DTM_T, F64)
        step = jax.jit(jdtm.make_step(packed, K, W.DTM_T, chunk_docs=8, axis_name=None,
                                      **kw, **W.DTM_CG))
        elbo = jax.jit(jdtm.make_elbo(packed, K, W.DTM_T, chunk_docs=8))
        args = eargs = (jnp.asarray(slice_id.astype(np.int32)), *tok, dm)
    else:   # HMTM
        state = jhmtm.init(key, packed, K, F64)
        step = jax.jit(jhmtm.make_step(packed, K, chunk_docs=8, axis_name=None, **kw))
        elbo = jax.jit(jhmtm.make_elbo(packed, K, chunk_docs=8))
        args, eargs = (*tok, dm, M), (*tok, dm)
    init = {f: np.asarray(v) for f, v in state._asdict().items()}

    def run():
        s, trace = state, []
        for _ in range(W.TP_ITERS):
            s = step(s, *args)
            trace.append(elbo_value(elbo(s, *eargs)))
        return trace, {f: np.asarray(v) for f, v in s._asdict().items()}
    return init, run


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case's JAX run beside the four ranks' port runs, one init."""
    job = str(tmp_path_factory.mktemp("tp"))
    inits, runners = {}, {}
    for case in W.TP_CASES:
        init, runners[case] = jax_case(case)
        inits.update({f"{case}/{f}": v for f, v in init.items()})
    corp = W.corpora(tm)["LDA"]
    jm = tm.LDA(corp, W.K, runtime=JaxRuntimeConfig(**W.RUNTIME),
                mesh=jax_make_mesh(n_devices=4, **API_MESH), seed=3)
    inits.update({f"api/{f}": np.asarray(v) for f, v in jm.state._asdict().items()})
    np.savez(os.path.join(job, "init.npz"), **inits)
    launch = W.Launch(job, "tp", W.TP_WORLD)
    try:
        jax_out = {case: run() for case, run in runners.items()}
        jm.train(iter=W.ITERS, checkelbo=1, printelbo=False)
    finally:
        outs = launch.finish(TIMEOUT)
    return dict(outs=outs, jax=jax_out, api=jm, job=job)


def _close(got, want, what):
    assert np.shape(got) == np.shape(want), (what, np.shape(got), np.shape(want))
    if what.endswith("elbo"):   # a (hi, lo) pair: its value
        got, want = np.sum(got), np.sum(want)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-12, err_msg=what)


@pytest.mark.parametrize("case", list(W.TP_CASES))
def test_case_follows_jax_with_ranks_bitwise_equal(runs, case):
    outs = runs["outs"]
    trace, state = runs["jax"][case]
    names = sorted(k for k in outs[0] if k.startswith(f"{case}/"))
    assert f"{case}/trace" in names
    for k in names:   # every global, the gathered state and the bound
        if "/doc_" in k or k.endswith("/rows"):
            continue   # a streaming rank's own rows of the host state
        for o in outs[1:]:
            np.testing.assert_array_equal(o[k], outs[0][k], err_msg=f"ranks differ on {k}")
    assert len(trace) == W.TP_ITERS
    np.testing.assert_allclose(outs[0][f"{case}/trace"], trace, rtol=RTOL)
    if W.TP_CASES[case]["family"] == "StreamingLDA":
        for f in ("beta", "beta_old", "alpha"):
            _close(outs[0][f"{case}/{f}"], state[f], f"{case} {f}")
        for o in outs:   # each rank's rows of the host state
            rows = o[f"{case}/rows"]
            for n in ("gamma", "Elogtheta", "Elogtheta_old"):
                _close(o[f"{case}/doc_{n}"], state[f"doc_{n}"][rows], f"{case} {n}")
        return
    for f, want in state.items():
        _close(outs[0][f"{case}/{f}"], want, f"{case} {f}")


def test_api_model_on_a_data_vocab_mesh_shards_over_the_data_axis(runs):
    """The api LDA on a 2 × 2 (data, vocab) mesh: two slabs, each held by
    two replicas bit for bit, the whole following the JAX model on the
    same mesh; its checkpoint directory (written once a slab) loads in
    both packages."""
    outs, jm = runs["outs"], runs["api"]
    for o in outs:
        assert int(o["api/n_shards"]) == 2
    assert [int(o["api/replica"]) for o in outs] == [0, 1, 0, 1]
    for f, v in jm.state._asdict().items():
        if f in tt.LDA._per_doc_fields:
            for a, b in ((0, 1), (2, 3)):   # the replicas of a slab
                np.testing.assert_array_equal(outs[a][f"api/{f}"], outs[b][f"api/{f}"])
            got = np.concatenate([outs[0][f"api/{f}"], outs[2][f"api/{f}"]])
        else:
            for o in outs[1:]:
                np.testing.assert_array_equal(o[f"api/{f}"], outs[0][f"api/{f}"])
            got = outs[0][f"api/{f}"]
        _close(got, np.asarray(v), f"api {f}")
    np.testing.assert_allclose(outs[0]["api/trace"], [r.elbo for r in jm.trainer.trace],
                               rtol=RTOL)
    path = os.path.join(runs["job"], "ckpt_api")
    assert sorted(os.listdir(path)) == ["manifest.json", "proc0.npz", "proc1.npz"]
    back = tt.load_checkpoint(path, W.corpora(tt)["LDA"], device="cpu")
    jback = tm.load_checkpoint(path, W.corpora(tm)["LDA"])
    np.testing.assert_array_equal(np.asarray(jback.beta), outs[0]["api/beta"])
    np.testing.assert_array_equal(back.beta, outs[0]["api/beta"])
    np.testing.assert_array_equal(back.gamma, np.asarray(jback.gamma))


@pytest.mark.parametrize("n_shards,pad", [(1, 8), (2, 8), (4, 8), (4, 1)])
def test_route_packed_is_byte_identical_to_jax(n_shards, pad):
    pk = W.dense(tt, 24, 64, 16, 5)
    got = tt.route_packed(pk, n_shards=n_shards, pad_multiple=pad)
    want = jpk.route_packed(W.dense(tm, 24, 64, 16, 5), n_shards=n_shards, pad_multiple=pad)
    for f in ("terms", "counts", "doc_mask", "N", "C"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes(), f
    for f in ("M", "V", "Vs", "n_shards", "Ls", "L", "fill", "M_pad"):
        assert getattr(got, f) == getattr(want, f), f
    with pytest.raises(ValueError, match="divide evenly"):
        tt.route_packed(pk, n_shards=5)


def test_routed_corpus_is_refused_by_save_and_trim(tmp_path):
    routed = tt.route_packed(W.dense(tt, 16, 32, 8, 2), n_shards=2)
    with pytest.raises(ValueError, match="RoutedCorpus"):
        tt.save_packed(str(tmp_path / "r"), routed)
    with pytest.raises(ValueError, match="RoutedCorpus"):
        tt.trim_packed(routed)
    assert not os.path.exists(tmp_path / "r")


def _chunk(seed, B=6, L=11, K=5, V=23):
    g = torch.Generator().manual_seed(seed)
    dt = torch.float64
    terms = torch.randint(0, V, (B, L), generator=g, dtype=torch.int64).to(torch.int32)
    counts = torch.randint(1, 4, (B, L), generator=g).to(dt)
    counts[torch.rand(B, L, generator=g) < 0.3] = 0.0
    counts[1] = 0.0                                   # an empty document
    doc_mask = torch.ones(B, dtype=dt)
    doc_mask[2] = 0.0                                 # a padding row
    betaT = torch.rand(V, K, generator=g, dtype=dt) + 1e-3
    alpha = torch.rand(K, generator=g, dtype=dt) + 0.1
    state = (torch.ones(B, K, dtype=dt), torch.full((B, K), -1.2, dtype=dt),
             torch.full((B, K), -1.2, dtype=dt))
    return betaT, terms.long(), counts, doc_mask, alpha, state


@pytest.mark.parametrize("viter", [0, 1, 3, 20])
def test_split_fixpoint_without_collective_equals_lda_estep_ref(viter):
    betaT, terms, counts, dm, alpha, state = _chunk(viter)
    want = lda_estep_ref(betaT, terms, counts, dm, alpha, *state, viter=viter, vtol=1e-4)
    got = split_fixpoint(betaT, terms, counts, dm, alpha, *state, viter=viter, vtol=1e-4)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_pass_over_split_slots_sums_to_the_whole_pass():
    """The pass mode's plain version on two halves of every document's
    slots, summed, is the pass on the whole (the statistic is a sum of
    per-slot terms, each with its own normaliser); padding rows give 0."""
    betaT, terms, counts, dm, _, (_, El, _) = _chunk(7, L=12)
    whole = lda_estep_pass(betaT, terms, counts, dm, El)
    halves = sum(lda_estep_pass(betaT, terms[:, h], counts[:, h], dm, El)
                 for h in (slice(0, 6), slice(6, 12)))
    torch.testing.assert_close(halves, whole, rtol=1e-13, atol=0.0)
    assert torch.equal(whole[2], torch.zeros_like(whole[2]))
    assert torch.equal(whole, lda_estep_pass_ref(betaT, terms, counts, dm, El))


class _SeqMesh:
    """Process ``i``'s coordinates on a (data, seq) mesh of 1 × ``n``, with
    no process group (``local_slab`` reads only the coordinates)."""

    mesh_dim_names = ("data", "seq")

    def __init__(self, n, i):
        self.n, self.i = n, i

    def size(self, dim=None):
        return (1, self.n)[dim] if dim is not None else self.n

    def get_local_rank(self, axis):
        return self.i if axis == "seq" else 0


@pytest.mark.parametrize("n", [2, 4])
def test_local_slab_cuts_the_reader_slots_with_the_token_slots(n):
    """A sequence rank's slab of a corpus with readers holds its block of
    the token and of the reader slot columns (JAX's ``P("data", "seq")``
    on both), every document's N, C and R whole; its reader plans cover
    its own columns, so the slabs' he statistics sum to the whole's."""
    from topicmodelsvb_jl_torch.models.ctpf import reader_plans
    from topicmodelsvb_jl_torch.models.lda import _chunks
    from topicmodelsvb_jl_torch.ops.segment import count_scatter_into
    from topicmodelsvb_jl_torch.parallel.multihost import local_slab

    packed, _ = W.tp_corpus(tt, "CTPF_seq")
    slabs = [local_slab(packed, _SeqMesh(n, i), "data", "seq") for i in range(n)]
    for f in ("terms", "counts", "readers", "ratings"):
        np.testing.assert_array_equal(np.concatenate([getattr(s, f) for s in slabs], axis=1),
                                      getattr(packed, f), err_msg=f)
    for s in slabs:
        assert (s.L, s.Rmax, s.M_pad, s.U) == (packed.L // n, packed.Rmax // n, packed.M_pad,
                                               packed.U)
        for f in ("N", "C", "R", "doc_mask"):
            np.testing.assert_array_equal(getattr(s, f), getattr(packed, f), err_msg=f)

    def he_stat(p):
        acc = torch.zeros((p.U, 1), dtype=torch.float64)
        for (rows, _, _), plan in zip(_chunks(p, 8), reader_plans(p, 8, "cpu")):
            count_scatter_into(acc, torch.as_tensor(p.ratings[rows]).reshape(-1, 1), plan)
        return acc

    torch.testing.assert_close(sum(he_stat(s) for s in slabs), he_stat(packed), rtol=1e-15,
                               atol=0.0)
    with pytest.raises(ValueError, match="reader slots do not divide"):
        local_slab(packed, _SeqMesh(3, 0), "data", "seq")   # L = 24 divides, Rmax = 16 not
