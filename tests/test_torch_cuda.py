"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

Every test here needs a CUDA device and skips without one; on a GPU
machine run ``python -m pytest tests/test_torch_cuda.py``.  This file
imports no JAX, so it runs where only the port is installed.
Tolerances are the JAX package's own for Pallas vs XLA in f32: rtol 5e-3,
atol 1e-5 on the state and rows, 1e-5 relative on the bound.
"""

import numpy as np
import pytest
import torch

import topicmodelsvb_jl_torch as tt
from topicmodelsvb_jl_torch.kernels import ctpf_estep as ctpf_estep_mod
from topicmodelsvb_jl_torch.kernels import flda_estep as flda_estep_mod
from topicmodelsvb_jl_torch.kernels.ctpf_estep import (
    ctpf_estep, ctpf_estep_pass, ctpf_estep_pass_ref, ctpf_estep_ref, ctpf_split_fixpoint,
)
from topicmodelsvb_jl_torch.kernels.flda_estep import (
    flda_estep, flda_estep_pass, flda_estep_pass_ref, flda_estep_ref, flda_split_fixpoint,
)
from topicmodelsvb_jl_torch.kernels.hmtm_estep import (
    hmtm_estep, hmtm_estep_ref, hmtm_logz, hmtm_logz_ref,
)
from topicmodelsvb_jl_torch.kernels.lda_elbo import lda_elbo_tok, lda_elbo_tok_ref
from topicmodelsvb_jl_torch.kernels import lda_estep as lda_estep_mod
from topicmodelsvb_jl_torch.kernels.lda_estep import (
    lda_estep, lda_estep_pass, lda_estep_pass_ref, lda_estep_ref, split_fixpoint,
)
from topicmodelsvb_jl_torch.kernels.scatter_rows import build_plan, scatter_rows, scatter_rows_ref
from topicmodelsvb_jl_torch.models.lda import token_plans
from topicmodelsvb_jl_torch.ops.segment import count_scatter_into
from topicmodelsvb_jl_torch.utils.numerics import EPSILON


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _chunk(K, B, L, V, dev, seed=0):
    """Tables, one chunk of documents with a warm state, and its tables'
    ELBO twins; the last 3 documents are padding."""
    r = np.random.default_rng(seed)
    beta = r.dirichlet(np.ones(V), size=K)
    beta_old = r.dirichlet(np.ones(V), size=K)
    terms = (V * r.random((B, L)) ** 3).astype(np.int32)
    counts = (1 + r.poisson(0.35, size=(B, L))).astype(np.float32)
    counts *= np.arange(L)[None, :] < r.integers(1, L + 1, size=B)[:, None]
    terms[counts == 0] = 0
    doc_mask = np.ones(B, np.float32)
    doc_mask[-3:] = 0.0
    counts[-3:] = 0.0
    alpha = r.uniform(0.2, 1.5, K)
    gamma = alpha + r.uniform(0.1, 5.0, size=(B, K))
    g = torch.tensor(gamma)
    El = (torch.special.digamma(g) - torch.special.digamma(g.sum(-1, keepdim=True))).numpy()
    El_old = El + r.normal(0, 0.05, size=(B, K))
    bo = beta_old.T + EPSILON
    g2 = bo * (np.log(beta.T + EPSILON) - np.log(bo))
    t = lambda a, dt=torch.float32: torch.tensor(np.ascontiguousarray(a), dtype=dt, device=dev)
    estep = (t(beta.T + EPSILON), t(terms, torch.int32), t(counts), t(doc_mask), t(alpha),
             t(gamma), t(El), t(El_old))
    elbo = (t(bo), t(g2), estep[1], estep[2], estep[3], estep[6], estep[7])
    return estep, elbo


# K: one topic, CTM's 50, LDA's 100, fLDA's 101 (K % 4 != 0: 4-byte copies
# and stores), wider than the block; L: short, the NSF buckets' 64 and 128
# (rows in shared memory), 1024 (rows in tiles re-read from the table)
@pytest.mark.parametrize("K", [1, 50, 100, 101, 257])
@pytest.mark.parametrize("L", [8, 64, 128, 1024])
def test_lda_estep_kernel_matches_plain(cuda, K, L):
    args, _ = _chunk(K, 64, L, 3000, cuda)
    before = lda_estep.launches
    got = lda_estep(*args, viter=10, vtol=1.0 / K**2)
    torch.cuda.synchronize()
    assert lda_estep.launches == before + 1
    want = lda_estep_ref(*args, viter=10, vtol=1.0 / K**2)
    for name, a, b in zip(("gamma", "El", "El_old", "w"), got, want):
        torch.testing.assert_close(a, b, rtol=5e-3, atol=1e-5, msg=name)
    assert torch.all(got[3][-3:] == 0)
    for a, b in zip(got[:3], args[5:]):
        assert torch.equal(a[-3:], b[-3:])   # padded documents frozen
    again = lda_estep(*args, viter=10, vtol=1.0 / K**2)
    assert all(torch.equal(a, b) for a, b in zip(got, again))   # bitwise repeatable


# rows in shared memory (K % 4 == 0 and not), rows in tiles, and slots too
# many for the slot list to stay in shared memory (a [B, 3 L] scratch)
@pytest.mark.parametrize("K,L", [(100, 128), (101, 64), (100, 1024), (7, 6000)])
@pytest.mark.parametrize("viter", [0, 3])
def test_lda_estep_kernel_special_documents(cuda, K, L, viter):
    """A document masked out but with counts (frozen state, w from its
    El_old), a real document with no counts (gamma = alpha + eps, w = 0),
    and viter 0 (no pass: w from the state as given)."""
    (betaT, terms, counts, doc_mask, *rest), _ = _chunk(K, 16, L, 3000, cuda, seed=4)
    doc_mask[0] = 0.0
    counts[1] = 0.0
    args = (betaT, terms, counts, doc_mask, *rest)
    got = lda_estep(*args, viter=viter, vtol=1.0 / K**2)
    want = lda_estep_ref(*args, viter=viter, vtol=1.0 / K**2)
    for name, a, b in zip(("gamma", "El", "El_old", "w"), got, want):
        torch.testing.assert_close(a, b, rtol=5e-3, atol=1e-5, msg=name)
    for a, b in zip(got[:3], rest[1:]):
        assert torch.equal(a[0], b[0])
    assert torch.any(got[3][0] != 0) and torch.all(got[3][1] == 0)
    if viter:
        torch.testing.assert_close(got[0][1], rest[0] + EPSILON, rtol=1e-6, atol=0)
    else:
        assert all(torch.equal(a, b) for a, b in zip(got[:3], rest[1:]))


@pytest.mark.parametrize("K,L", [(7, 24), (100, 136), (100, 700), (160, 40)])
def test_lda_elbo_tok_kernel_matches_plain(cuda, K, L):
    _, args = _chunk(K, 64, L, 3000, cuda, seed=1)
    before = lda_elbo_tok.launches
    got = lda_elbo_tok(*args)
    again = lda_elbo_tok(*args)
    assert lda_elbo_tok.launches == before + 2
    want = lda_elbo_tok_ref(*args)
    assert torch.equal(got, again)   # no atomics: bitwise repeatable
    assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))


# CTM's K = 50 (8-byte row loads) at the NSF width, LDA's K = 100 at
# L = 1024 (one thread a slot), K = 7 at L = 8 (4-byte loads, 8 threads a
# slot)
@pytest.mark.parametrize("K,L", [(50, 128), (100, 1024), (7, 8)])
def test_lda_elbo_tok_kernel_special_documents(cuda, K, L):
    """A document masked out but with counts, and a real document with
    no counts."""
    _, (boT, g2T, terms, counts, doc_mask, El, El_old) = _chunk(K, 64, L, 3000, cuda, seed=2)
    doc_mask[0] = 0.0
    counts[1] = 0.0
    args = (boT, g2T, terms, counts, doc_mask, El, El_old)
    got = lda_elbo_tok(*args)
    want = lda_elbo_tok_ref(*args)
    assert torch.equal(got, lda_elbo_tok(*args))
    assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))
    # the masked document adds nothing; the empty one adds 0
    doc_mask[1] = 0.0
    torch.testing.assert_close(lda_elbo_tok(*args), got, rtol=1e-6, atol=0)


def test_lda_elbo_tok_kernel_raw_beta_old_zero_row(cuda):
    """CTM's tables from a raw beta_old: padding slots over an all-zero
    row add nothing (no NaN); a real token over it is not finite in both
    versions (s = 0: degeneracy surfaced, not masked)."""
    K, B, L, V = 50, 32, 128, 3000
    r = np.random.default_rng(7)
    beta = r.dirichlet(np.ones(V), size=K)
    bo = r.dirichlet(np.ones(V), size=K).T.copy()
    z = 5
    bo[z] = 0.0
    g2 = np.where(bo > 0, bo * (np.log(beta.T + EPSILON) - np.log(np.where(bo > 0, bo, 1.0))), 0.0)
    terms = np.where(r.random((B, L)) < 0.8, r.integers(6, V, size=(B, L)), z).astype(np.int32)
    counts = (terms != z) * (1.0 + r.poisson(0.35, size=(B, L)))
    el = r.normal(-4.0, 1.0, size=(B, K))
    t = lambda a, dt=torch.float32: torch.tensor(np.ascontiguousarray(a), dtype=dt, device=cuda)
    args = [t(bo), t(g2), t(terms, torch.int32), t(counts), t(np.ones(B)), t(el),
            t(el + r.normal(0, 0.05, size=(B, K)))]
    got, want = lda_elbo_tok(*args), lda_elbo_tok_ref(*args)
    assert torch.isfinite(got) and torch.isfinite(want)
    assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))
    args[3] = args[3].clone()
    args[3][0, int(np.argmax(terms[0] == z))] = 1.0
    got, want = lda_elbo_tok(*args), lda_elbo_tok_ref(*args)
    assert not torch.isfinite(got) and not torch.isfinite(want)
    assert bool(torch.isnan(got)) == bool(torch.isnan(want))


# the pass mode (routed tensor parallelism, the sequence axis): odd L and
# K, rows in shared memory and (L = 1025 at K >= 100) in tiles; since the
# warp mode, one warp a document (L = 7: four documents a CTA), several
# (L = 64, 129) and 8 (L = 512, 1025), 8 or 16 lanes a slot (K = 3, 100),
# a whole warp of three vectors (K = 257) and K past its reach (600: the
# block mode)
PASS_K = [3, 100, 257, 600]
PASS_L = [7, 64, 129, 512, 1025]


def _check_pass_shape(shape, L, K):
    """The warp mode's shape (lanes a slot, vectors a lane, warps a
    document) for the regime the case is meant to reach."""
    G, nvl, w = shape
    if K > 512:
        assert G == 0, shape                            # the block mode
        return
    assert G in (8, 16, 32) and 4 * G * nvl >= K and 1 <= w <= 8, shape
    assert w == 1 if L <= 32 else (w == 8 if L > 512 else w > 1), shape


def _pass_layouts(terms, counts):
    """The chunk's own random lengths, then one long document among short
    ones: document 0 takes every slot, the others at most 5 (padding slots
    keep id 0 and count 0); document 1 keeps no slot in both."""
    counts[1] = 0.0                                     # a real document with no slots
    yield "mixed", terms, counts
    t, c = terms.clone(), counts.clone()
    c[:, 5:] = 0.0
    c[0] = torch.where(counts[0] > 0, counts[0], torch.ones_like(counts[0]))
    t[0] = torch.where(counts[0] > 0, terms[0], torch.full_like(terms[0], 17))
    t[c == 0] = 0
    c[1] = 0.0
    yield "one_long", t, c


@pytest.mark.parametrize("K", PASS_K)
@pytest.mark.parametrize("L", PASS_L)
def test_lda_estep_pass_kernel_matches_plain(cuda, K, L):
    (betaT, terms, counts, doc_mask, _, _, El, _), _ = _chunk(K, 40, L, 3000, cuda, seed=K + L)
    _check_pass_shape(lda_estep_mod.pass_shape(L, K), L, K)
    for layout, terms, counts in _pass_layouts(terms, counts):
        before = lda_estep_pass.launches
        got = lda_estep_pass(betaT, terms, counts, doc_mask, El)
        torch.cuda.synchronize()
        assert lda_estep_pass.launches == before + 1, layout
        want = lda_estep_pass_ref(betaT, terms, counts, doc_mask, El)
        torch.testing.assert_close(got, want, rtol=5e-3, atol=1e-5, msg=layout)
        assert torch.all(got[-3:] == 0) and torch.all(got[1] == 0), layout
        again = lda_estep_pass(betaT, terms, counts, doc_mask, El)
        assert torch.equal(got, again), layout               # bitwise repeatable


def test_lda_estep_pass_kernel_empty_chunk_and_rejects(cuda):
    (betaT, terms, counts, doc_mask, _, _, El, _), _ = _chunk(7, 5, 24, 100, cuda)
    before = lda_estep_pass.launches
    pc = lda_estep_pass(betaT, terms[:0], counts[:0], doc_mask[:0], El[:0])
    assert pc.shape == (0, 7) and lda_estep_pass.launches == before
    with pytest.raises(TypeError, match="El"):
        lda_estep_pass(betaT, terms, counts, doc_mask, El.double())
    with pytest.raises(TypeError, match="terms"):
        lda_estep_pass(betaT, terms.long(), counts, doc_mask, El)


@pytest.mark.parametrize("K,L", [(3, 13), (100, 129), (100, 1025)])
def test_lda_estep_at_viter_zero_keeps_the_state_and_writes_the_rows(cuda, K, L):
    """The split fixpoint's last call: no pass, the state returned as
    given, w from exp(El_old) with each slot's own normaliser."""
    args, _ = _chunk(K, 24, L, 3000, cuda, seed=3)
    got = lda_estep(*args, viter=0, vtol=1.0 / K**2)
    for a, b in zip(got[:3], args[5:]):
        assert torch.equal(a, b)
    want = lda_estep_ref(*args, viter=0, vtol=1.0 / K**2)
    torch.testing.assert_close(got[3], want[3], rtol=5e-3, atol=1e-5)


def test_split_fixpoint_runs_the_kernels_and_never_the_plain_versions(cuda, monkeypatch):
    """On CUDA tensors the split fixpoint launches the pass kernel a pass
    and the E-step kernel once, and follows the plain fixpoint."""
    args, _ = _chunk(100, 48, 129, 3000, cuda, seed=9)
    want = lda_estep_ref(*args, viter=10, vtol=1e-4)

    def refused(*a, **k):
        raise AssertionError("a CUDA tensor ran a plain version")

    monkeypatch.setattr(lda_estep_mod, "lda_estep_ref", refused)
    monkeypatch.setattr(lda_estep_mod, "lda_estep_pass_ref", refused)
    p0, e0 = lda_estep_pass.launches, lda_estep.launches
    got = split_fixpoint(*args, viter=10, vtol=1e-4, reduce=lambda x: x)
    assert lda_estep_pass.launches - p0 >= 1 and lda_estep.launches - e0 == 1
    for name, a, b in zip(("gamma", "El", "El_old", "w"), got, want):
        torch.testing.assert_close(a, b, rtol=5e-3, atol=1e-5, msg=name)


def test_routed_and_seq_lda_steps_on_one_card_follow_the_plain_step(cuda):
    """A one-rank routed step (one vocab block) and a sequence-axis step
    with no mesh go through the pass kernel and follow the dense step."""
    from topicmodelsvb_jl_torch.models import lda

    pk = tt.synth_packed_nsf_scale(M=512, V=600, mean_terms=30, seed=5)
    routed = tt.route_packed(pk, n_shards=1)
    K, kw = 20, dict(viter=10, vtol=1.0 / 400, niter=100, ntol=1.0 / 400, chunk_docs=128,
                     device=cuda)
    state = lda.init(torch.Generator().manual_seed(1), pk, K, device=cuda)
    put = lambda p: (torch.as_tensor(p.terms, dtype=torch.int32, device=cuda),
                     torch.as_tensor(p.counts, dtype=torch.float32, device=cuda),
                     torch.as_tensor(p.doc_mask, dtype=torch.float32, device=cuda))
    want = lda.make_step(pk, K, **kw)(state, *put(pk), float(pk.M))
    p0 = lda_estep_pass.launches
    for p, modes in ((routed, dict(vocab_axis="vocab", vocab_routed=True)),
                     (pk, dict(seq_axis="seq"))):
        got = lda.make_step(p, K, **kw, **modes)(state, *put(p), float(pk.M))
        for f in ("alpha", "beta", "gamma", "Elogtheta"):
            torch.testing.assert_close(getattr(got, f), getattr(want, f), rtol=5e-3,
                                       atol=1e-5, msg=f)
    assert lda_estep_pass.launches > p0


def test_empty_chunk_launches_nothing(cuda):
    args, eargs = _chunk(7, 3, 24, 100, cuda)
    e0, k0 = lda_estep.launches, lda_elbo_tok.launches
    betaT, t, c, dm, alpha, gam, el, elo = args
    g, el, elo, w = lda_estep(betaT, t[:0], c[:0], dm[:0], alpha, gam[:0], el[:0],
                              elo[:0], viter=2, vtol=1e-3)
    assert g.shape == (0, 7) and w.shape == (0, 24, 7)
    assert float(lda_elbo_tok(eargs[0], eargs[1], *(a[:0] for a in eargs[2:]))) == 0.0
    assert (lda_estep.launches, lda_elbo_tok.launches) == (e0, k0)


def test_kernels_reject_what_they_do_not_take(cuda):
    args, eargs = _chunk(7, 16, 24, 100, cuda)
    # the table's dtype picks the mode (float32 or float64); no float16 one
    with pytest.raises(TypeError, match="betaT"):
        lda_estep(args[0].half(), *args[1:], viter=2, vtol=1e-3)
    with pytest.raises(TypeError, match="counts must be torch.float64"):
        lda_estep(args[0].double(), *args[1:], viter=2, vtol=1e-3)
    with pytest.raises(TypeError, match="terms"):
        lda_estep(args[0], args[1].long(), *args[2:], viter=2, vtol=1e-3)
    with pytest.raises(ValueError, match="counts"):
        lda_estep(args[0], args[1], args[2].cpu(), *args[3:], viter=2, vtol=1e-3)
    with pytest.raises(ValueError, match="contiguous"):
        lda_elbo_tok(eargs[0], eargs[1], eargs[2], eargs[3], eargs[4],
                     eargs[5].T.contiguous().T, eargs[6])


def test_count_scatter_is_bitwise_repeatable(cuda):
    r = np.random.default_rng(0)
    ids = (500 * r.random(200_000) ** 3).astype(np.int32)     # Zipf head: long runs
    keep = r.random(200_000) > 0.2
    w = torch.rand((200_000, 100), device=cuda) * torch.tensor(keep, device=cuda)[:, None]
    plan = build_plan(ids, keep).to(cuda)
    a = count_scatter_into(torch.zeros(500, 100, device=cuda), w, plan)
    b = count_scatter_into(torch.zeros(500, 100, device=cuda), w, plan)
    assert torch.equal(a, b)
    ref = torch.zeros(500, 100, dtype=torch.float64).index_add_(
        0, torch.from_numpy(ids).long(), w.cpu().double())
    torch.testing.assert_close(a.cpu().double(), ref, rtol=1e-5, atol=1e-3)


# W: one column, CTM's 50 and fCTM's 51, LDA's 100 (16-byte rows), fLDA's
# 101, wider than a warp's 32 lanes; pieces of 1 row (every run split),
# 7 and 300 rows
@pytest.mark.parametrize("W", [1, 50, 51, 100, 101, 257])
@pytest.mark.parametrize("piece_rows", [1, 7, 300])
def test_scatter_rows_kernel_matches_plain(cuda, W, piece_rows):
    r = np.random.default_rng(W)
    T, V = 50_000, 2000
    ids = np.minimum((V * r.random(T) ** 3).astype(np.int32), V - 1)
    keep = r.random(T) > 0.3
    ids[~keep] = 0
    w = torch.tensor(r.random((T, W)) * keep[:, None], dtype=torch.float32, device=cuda)
    plan = build_plan(ids, keep, piece_rows).to(cuda)
    assert plan.run_id.shape[0] > 0   # split runs
    acc0 = torch.rand((V, W), device=cuda)
    before = scatter_rows.launches
    got = scatter_rows(acc0.clone(), w, plan)
    torch.cuda.synchronize()
    assert scatter_rows.launches == before + 1
    want = scatter_rows_ref(acc0.clone(), w, plan)
    torch.testing.assert_close(got, want, rtol=5e-3, atol=1e-5)
    assert torch.equal(got, scatter_rows(acc0.clone(), w, plan))   # no atomics


def test_scatter_rows_edge_cases(cuda):
    """One id for every kept row; nothing kept (no launch); ids past acc."""
    w = torch.rand((9000, 100), device=cuda)
    one = build_plan(np.full(9000, 3, np.int32), np.ones(9000, bool)).to(cuda)
    got = scatter_rows(torch.zeros(10, 100, device=cuda), w, one)
    torch.testing.assert_close(got[3], w.double().sum(0).float(), rtol=1e-5, atol=1e-3)
    assert torch.all(got[torch.arange(10, device=cuda) != 3] == 0)
    before = scatter_rows.launches
    empty = build_plan(np.zeros(0, np.int32), np.zeros(0, bool)).to(cuda)
    acc = torch.ones(10, 100, device=cuda)
    assert torch.equal(scatter_rows(acc, w[:0], empty), torch.ones(10, 100, device=cuda))
    none = build_plan(np.zeros(9000, np.int32), np.zeros(9000, bool)).to(cuda)
    assert torch.equal(scatter_rows(acc, w, none), torch.ones(10, 100, device=cuda))
    assert scatter_rows.launches == before
    with pytest.raises(ValueError, match="reach 3"):
        scatter_rows(torch.zeros(3, 100, device=cuda), w, one)
    with pytest.raises(ValueError, match="weights"):
        scatter_rows(torch.zeros(10, 100, device=cuda), w[:100], one)
    with pytest.raises(ValueError, match="rows is on cpu"):
        scatter_rows(torch.zeros(10, 100, device=cuda), w, one.to("cpu"))


def test_lda_trains_through_the_kernels(cuda):
    p = tt.synth_packed_nsf_scale(M=3000, V=800, mean_terms=40, seed=2)
    m = tt.LDA(p, 16, tt.RuntimeConfig(chunk_docs=256), device=cuda, seed=1)
    e0, k0 = lda_estep.launches, lda_elbo_tok.launches
    m.train(iter=3, checkelbo=1, printelbo=False)
    n_chunks = sum(s.terms.shape[0] for s in m.packed.segments) // m.chunk_docs
    assert lda_estep.launches - e0 == 3 * n_chunks
    assert lda_elbo_tok.launches - k0 == 4 * n_chunks
    assert all(r.delta_elbo > 0 for r in m.trainer.trace)


def _flda_chunk(K, B, L, V, dev, seed=0):
    """fLDA E-step arguments for one chunk; the last 3 documents are padding."""
    (betaT, terms, counts, doc_mask, alpha, gamma, El, El_old), _ = _chunk(K, B, L, V, dev, seed)
    r = np.random.default_rng(seed + 100)
    kappa = torch.tensor(r.dirichlet(np.ones(V)), dtype=torch.float32, device=dev)
    tau = torch.tensor(r.uniform(0.1, 0.9, size=(2, B, L)), dtype=torch.float32, device=dev)
    eta = torch.tensor(0.6, device=dev)
    return (torch.log(betaT), kappa, terms, counts, doc_mask, alpha, eta, gamma, El, El_old,
            tau[0].contiguous(), tau[1].contiguous())


# (100, 128): the widest NSF bucket, rows in shared memory;
# (100, 1024): rows beyond the shared-memory limit, read from the table
@pytest.mark.parametrize("K,L", [(7, 24), (100, 128), (100, 1024), (160, 40)])
def test_flda_estep_kernel_matches_plain(cuda, K, L):
    args = _flda_chunk(K, 64, L, 3000, cuda)
    before = flda_estep.launches
    got = flda_estep(*args, viter=10, vtol=1.0 / K**2)
    torch.cuda.synchronize()
    assert flda_estep.launches == before + 1
    want = flda_estep_ref(*args, viter=10, vtol=1.0 / K**2)
    for name, a, b in zip(("gamma", "El", "El_old", "tau", "tau_old", "w"), got, want):
        torch.testing.assert_close(a, b, rtol=5e-3, atol=1e-5, msg=name)
    assert got[5].shape == (64, L, K + 1) and torch.all(got[5][-3:] == 0)
    for a, b in zip(got[:5], args[7:]):
        assert torch.equal(a[-3:], b[-3:])   # padded documents frozen
    again = flda_estep(*args, viter=10, vtol=1.0 / K**2)
    assert all(torch.equal(a, b) for a, b in zip(got, again))   # bitwise repeatable


# rows in shared memory (K % 4 == 0 and not), rows in tiles, and slots too
# many for the slot list to stay in shared memory (a [B, 7 L] scratch)
@pytest.mark.parametrize("K,L", [(7, 24), (100, 128), (7, 2000), (100, 1024), (7, 9000)])
@pytest.mark.parametrize("viter", [0, 3])
def test_flda_estep_kernel_special_documents(cuda, K, L, viter):
    """A document masked out but with counts (frozen state, w from its
    tau_old and El_old), a real document with no counts (gamma = alpha +
    eps, w = 0, tau still updated on its padding slots), and viter 0 (no
    pass: w from the state as given)."""
    (logbetaT, kappa, terms, counts, doc_mask, alpha, eta, *state) = _flda_chunk(
        K, 16, L, 3000, cuda, seed=4)
    doc_mask[0] = 0.0
    counts[1] = 0.0
    args = (logbetaT, kappa, terms, counts, doc_mask, alpha, eta, *state)
    got = flda_estep(*args, viter=viter, vtol=1.0 / K**2)
    want = flda_estep_ref(*args, viter=viter, vtol=1.0 / K**2)
    for name, a, b in zip(("gamma", "El", "El_old", "tau", "tau_old", "w"), got, want):
        torch.testing.assert_close(a, b, rtol=5e-3, atol=1e-5, msg=name)
    for a, b in zip(got[:5], state):
        assert torch.equal(a[0], b[0])
    assert torch.any(got[5][0] != 0) and torch.all(got[5][1] == 0)
    if viter:
        torch.testing.assert_close(got[0][1], alpha + EPSILON, rtol=1e-6, atol=0)
        assert not torch.equal(got[3][1], state[3][1])
    else:
        assert all(torch.equal(a, b) for a, b in zip(got[:5], state))


def _ctpf_chunk(K, B, L, R, V, U, dev, seed=0):
    """CTPF E-step arguments for one chunk; the last 3 documents are padding."""
    r = np.random.default_rng(seed)
    t = lambda a, dt=torch.float32: torch.tensor(np.ascontiguousarray(a), dtype=dt, device=dev)
    gam = lambda *shape: 0.1 + r.gamma(2.0, 1.0, size=shape)
    terms = (V * r.random((B, L)) ** 3).astype(np.int32)
    counts = (1 + r.poisson(0.35, size=(B, L))) * (
        np.arange(L)[None, :] < r.integers(1, L + 1, size=B)[:, None])
    readers = r.integers(0, U, size=(B, R)).astype(np.int32)
    ratings = np.arange(R)[None, :] < r.integers(1, R + 1, size=B)[:, None]
    terms[counts == 0] = 0
    readers[~ratings] = 0
    counts[-3:] = 0
    ratings[-3:] = False
    doc_mask = np.ones(B)
    doc_mask[-3:] = 0
    g = torch.special.digamma(torch.tensor(gam(K, V)))
    h = torch.special.digamma(torch.tensor(gam(K, U)))
    dalet, bet, vav, het = (r.uniform(0.5, 3.0, K) for _ in range(4))
    gimel, zayin = gam(B, K), gam(B, K)
    return (t(torch.exp(g).T), t(torch.exp(h).T), t(terms, torch.int32), t(counts),
            t(readers, torch.int32), t(ratings), t(doc_mask), t(1 / (dalet * bet)),
            t(1 / (dalet * vav)), t(1 / (het * vav)), t(gimel), t(gimel * 1.1), t(zayin),
            t(zayin * 0.9))


HYP = dict(c_hyper=0.1, g_hyper=0.1)


CTPF_NAMES = ("gimel", "gimel_old", "zayin", "zayin_old", "wa", "wh")


def _ctpf_close(got, want):
    for name, a, b in zip(CTPF_NAMES, got, want):
        torch.testing.assert_close(a, b, rtol=5e-3, atol=1e-5, msg=name)


# (100, 80, 24): CiteULike's widest chunk, rows in shared memory;
# (100, 600, 64): L + R beyond the shared-memory limit, rows in tiles
# re-read from the tables; K = 7 and 9 (4-byte copies and stores), 160 and
# 300 (more topics than threads)
@pytest.mark.parametrize("K,L,R", [(9, 24, 8), (100, 80, 24), (100, 600, 64), (160, 40, 8),
                                   (7, 24, 8), (300, 40, 8)])
def test_ctpf_estep_kernel_matches_plain(cuda, K, L, R):
    args = _ctpf_chunk(K, 64, L, R, 3000, 500, cuda)
    before = ctpf_estep.launches
    got = ctpf_estep(*args, viter=10, vtol=1.0 / K**2, **HYP)
    torch.cuda.synchronize()
    assert ctpf_estep.launches == before + 1
    want = ctpf_estep_ref(*args, viter=10, vtol=1.0 / K**2, **HYP)
    _ctpf_close(got, want)
    assert torch.all(got[4][-3:] == 0) and torch.all(got[5][-3:] == 0)
    for a, b in zip(got[:4], args[10:]):
        assert torch.equal(a[-3:], b[-3:])   # padded documents frozen
    again = ctpf_estep(*args, viter=10, vtol=1.0 / K**2, **HYP)
    assert all(torch.equal(a, b) for a, b in zip(got, again))   # bitwise repeatable


def test_ctpf_estep_shared_memory_rule(cuda):
    """Which of the three layouts each test shape takes: rows resident,
    rows in tiles, and tiles with the slot list in a [B, 3 (L + R)]
    scratch."""
    import ctypes

    from topicmodelsvb_jl_torch.kernels import _build

    i64 = [ctypes.c_int64] * 3
    fit = _build.function("tmvb_ctpf_estep_rows_in_smem", i64)
    scratch = _build.function("tmvb_ctpf_estep_scratch", i64, ctypes.c_int64)
    for (K, L, R), want in {(100, 80, 24): (1, 0), (9, 24, 8): (1, 0), (100, 600, 64): (0, 0),
                            (100, 768, 256): (0, 0), (7, 5000, 1000): (0, 18000)}.items():
        assert (fit(L, R, K), scratch(L, R, K)) == want, (K, L, R)


# rows resident (K % 4 == 0 and not), in tiles, and in tiles with the slot
# list in device scratch
@pytest.mark.parametrize("K,L,R", [(100, 80, 24), (9, 24, 8), (100, 600, 64), (7, 5000, 1000)])
@pytest.mark.parametrize("viter", [0, 1, 3])
def test_ctpf_estep_kernel_special_documents(cuda, K, L, R, viter):
    """A document masked out but with counts and ratings (frozen state,
    wa/wh from its old state), one with tokens and no readers, one with
    readers and no tokens, an empty real one (gimel = c, zayin = g, no
    rows), and viter 0 and 1 (no pass: rows from the state as given; one
    pass: rows from the pass)."""
    args = list(_ctpf_chunk(K, 16, L, R, 3000, 500, cuda, seed=4))
    terms, counts, readers, ratings, doc_mask = args[2], args[3], args[4], args[5], args[6]
    doc_mask[0] = 0.0
    ratings[1], readers[1] = 0.0, 0
    counts[2], terms[2] = 0.0, 0
    counts[3], terms[3], ratings[3], readers[3] = 0.0, 0, 0.0, 0
    kw = dict(viter=viter, vtol=1.0 / K**2, **HYP)
    got = ctpf_estep(*args, **kw)
    _ctpf_close(got, ctpf_estep_ref(*args, **kw))
    state = args[10:]
    for a, b in zip(got[:4], state):
        assert torch.equal(a[0], b[0])
    wa, wh = got[4], got[5]
    assert torch.any(wa[0] != 0) and torch.any(wh[0] != 0)
    assert torch.all(wh[1] == 0) and torch.any(wa[1] != 0)
    assert torch.all(wa[2] == 0) and torch.any(wh[2] != 0)
    assert torch.all(wa[3] == 0) and torch.all(wh[3] == 0)
    if viter:
        assert torch.all(got[0][3] == HYP["c_hyper"]) and torch.all(got[2][3] == HYP["g_hyper"])
        # one pass leaves the given state in the old; a second finds (c, g)
        # again and stops there
        old = (state[0][3], state[2][3]) if viter == 1 else (got[0][3], got[2][3])
        assert torch.equal(got[1][3], old[0]) and torch.equal(got[3][3], old[1])
    else:
        assert all(torch.equal(a, b) for a, b in zip(got[:4], state))
    assert all(torch.equal(a, b) for a, b in zip(got, ctpf_estep(*args, **kw)))


def test_ctpf_estep_kernel_empty_documents_stop_together(cuda):
    """Empty real documents run one barrier a pass.  Pass 0 moves only the
    topics of one warp (b % 8 of 8 warps at K = 256); pass 1 moves none and
    stops.  Every warp must take pass 1: its topics' zayin_old is then g,
    not the zayin given."""
    B, K = 8192, 256
    args = list(_ctpf_chunk(K, B, 8, 8, 100, 50, cuda, seed=6))
    for a in args[2:6]:
        a.zero_()
    args[6].fill_(1.0)
    moved = (torch.arange(K, device=cuda)[None, :] // 32
             == torch.arange(B, device=cuda)[:, None] % 8)
    args[10] = HYP["c_hyper"] + moved.float()
    args[12] = torch.full((B, K), HYP["g_hyper"] + 1.0, device=cuda)
    kw = dict(viter=3, vtol=1.0 / K**2, **HYP)
    want = ctpf_estep_ref(*args, **kw)
    for _ in range(5):
        got = ctpf_estep(*args, **kw)
        _ctpf_close(got, want)
        assert torch.all(got[0] == HYP["c_hyper"]) and torch.all(got[1] == HYP["c_hyper"])
        assert torch.all(got[2] == HYP["g_hyper"]) and torch.all(got[3] == HYP["g_hyper"])
        assert torch.all(got[4] == 0) and torch.all(got[5] == 0)


def test_ctpf_estep_kernel_without_users(cuda):
    """A corpus without users: every rating 0 over the one placeholder
    user's row; the reader rows are zeros and the tokens alone move
    gimel."""
    args = list(_ctpf_chunk(100, 64, 80, 8, 3000, 1, cuda, seed=5))
    args[4].zero_()
    args[5].zero_()
    kw = dict(viter=10, vtol=1e-4, **HYP)
    got = ctpf_estep(*args, **kw)
    _ctpf_close(got, ctpf_estep_ref(*args, **kw))
    assert args[1].shape == (1, 100) and torch.all(got[5] == 0)
    assert torch.all(got[2][:-3] == HYP["g_hyper"])
    assert all(torch.equal(a, b) for a, b in zip(got, ctpf_estep(*args, **kw)))


def test_new_kernels_reject_what_they_do_not_take(cuda):
    fargs = _flda_chunk(7, 16, 24, 100, cuda)
    with pytest.raises(TypeError, match="eta"):
        flda_estep(*fargs[:6], fargs[6].double(), *fargs[7:], viter=2, vtol=1e-3)
    with pytest.raises(ValueError, match="tau"):
        flda_estep(*fargs[:10], fargs[10].T.contiguous().T, fargs[11], viter=2, vtol=1e-3)
    cargs = _ctpf_chunk(7, 16, 24, 8, 100, 50, cuda)
    with pytest.raises(TypeError, match="readers"):
        ctpf_estep(*cargs[:4], cargs[4].long(), *cargs[5:], viter=2, vtol=1e-3, **HYP)
    e0, c0 = flda_estep.launches, ctpf_estep.launches
    out = flda_estep(*(a[:0] if a.dim() and a.shape[0] == 16 else a for a in fargs),
                     viter=2, vtol=1e-3)
    assert out[5].shape == (0, 24, 8) and (flda_estep.launches, ctpf_estep.launches) == (e0, c0)


# the pass modes of flda_estep and ctpf_estep (the sequence axis): odd L
# (and R) and K, rows in shared memory and (L = 1025, L + R = 666 at
# K >= 100) in tiles
def _flda_pass_args(args):
    """flda_estep_pass's arguments from a _flda_chunk."""
    logbetaT, kappa, terms, counts, doc_mask, _, eta, _, El, _, tau, _ = args
    return logbetaT, kappa, terms, counts, doc_mask, eta, El, tau


@pytest.mark.parametrize("K", PASS_K)
@pytest.mark.parametrize("L", PASS_L)
def test_flda_estep_pass_kernel_matches_plain(cuda, K, L):
    args = list(_flda_pass_args(_flda_chunk(K, 40, L, 3000, cuda, seed=K + L)))
    _check_pass_shape(flda_estep_mod.pass_shape(L, K), L, K)
    for layout, args[2], args[3] in _pass_layouts(args[2], args[3]):
        before = flda_estep_pass.launches
        got = flda_estep_pass(*args)
        torch.cuda.synchronize()
        assert flda_estep_pass.launches == before + 1, layout
        want = flda_estep_pass_ref(*args)
        for name, a, b in zip(("pc", "tau_new"), got, want):
            torch.testing.assert_close(a, b, rtol=5e-3, atol=1e-5, msg=f"{layout} {name}")
        pc, tau_new = got
        pad = (args[3] == 0) & (args[4] > 0)[:, None]        # padding slots of real documents
        torch.testing.assert_close(tau_new[pad], want[1][pad], rtol=5e-3, atol=1e-5,
                                   msg=f"{layout} tau_new on padding")
        assert torch.all(pc[-3:] == 0) and torch.all(pc[1] == 0), layout
        assert torch.equal(tau_new[-3:], args[7][-3:]), layout   # masked: tau kept
        assert not torch.equal(tau_new[1], args[7][1]), layout   # no slots: tau still moves
        again = flda_estep_pass(*args)
        assert all(torch.equal(a, b) for a, b in zip(got, again)), layout   # bitwise repeatable


def test_flda_estep_pass_kernel_empty_chunk_and_rejects(cuda):
    args = _flda_pass_args(_flda_chunk(7, 5, 24, 100, cuda))
    before = flda_estep_pass.launches
    pc, tau_new = flda_estep_pass(*args[:2], *(a[:0] for a in args[2:5]), args[5],
                                  args[6][:0], args[7][:0])
    assert pc.shape == (0, 7) and tau_new.shape == (0, 24)
    assert flda_estep_pass.launches == before
    with pytest.raises(TypeError, match="El"):
        flda_estep_pass(*args[:6], args[6].double(), args[7])
    with pytest.raises(ValueError, match="tau"):
        flda_estep_pass(*args[:7], args[7].T.contiguous().T)


def _ctpf_pass_args(args):
    """ctpf_estep_pass's arguments from a _ctpf_chunk."""
    return (*args[:10], args[10], args[12])


@pytest.mark.parametrize("K", [3, 100, 257])
@pytest.mark.parametrize("L,R", [(7, 5), (129, 33), (601, 65)])
def test_ctpf_estep_pass_kernel_matches_plain(cuda, K, L, R):
    args = list(_ctpf_pass_args(_ctpf_chunk(K, 40, L, R, 3000, 500, cuda, seed=K + L)))
    args[3][1], args[2][1] = 0.0, 0                      # readers alone
    args[5][2], args[4][2] = 0.0, 0                      # tokens alone
    before = ctpf_estep_pass.launches
    got = ctpf_estep_pass(*args)
    torch.cuda.synchronize()
    assert ctpf_estep_pass.launches == before + 1
    want = ctpf_estep_pass_ref(*args)
    for name, a, b in zip(("gsum", "zsum"), got, want):
        torch.testing.assert_close(a, b, rtol=5e-3, atol=1e-5, msg=name)
        assert torch.all(a[-3:] == 0), name
    assert torch.all(got[1][2] == 0) and torch.any(got[0][1] != 0)
    again = ctpf_estep_pass(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, again))   # bitwise repeatable


def test_ctpf_estep_pass_kernel_empty_chunk_and_rejects(cuda):
    args = _ctpf_pass_args(_ctpf_chunk(7, 5, 24, 8, 100, 50, cuda))
    before = ctpf_estep_pass.launches
    gs, zs = ctpf_estep_pass(*args[:2], *(a[:0] for a in args[2:7]), *args[7:10],
                             args[10][:0], args[11][:0])
    assert gs.shape == zs.shape == (0, 7) and ctpf_estep_pass.launches == before
    with pytest.raises(TypeError, match="readers"):
        ctpf_estep_pass(*args[:4], args[4].long(), *args[5:])
    with pytest.raises(TypeError, match="zayin"):
        ctpf_estep_pass(*args[:11], args[11].double())


# the CTPF pass mode's warp mode: K from one topic to its reach (512, a
# whole warp of four vectors a slot) and past it (513: the block mode);
# L + R from one warp (12: four documents a CTA) to eight (1030), and no
# readers at all (R = 0)
CTPF_PASS_K = [1, 3, 100, 129, 512, 513]
CTPF_PASS_LR = [(7, 5), (40, 24), (129, 33), (300, 100), (900, 130), (64, 0)]


def _check_ctpf_pass_shape(shape, L, R, K):
    """The warp mode's shape for the regime the case is meant to reach,
    counted in the document's L + R slots."""
    G, nvl, w = shape
    if K > 512:
        assert G == 0, shape                            # the block mode
        return
    assert G in (8, 16, 32) and 1 <= nvl <= 4 and 4 * G * nvl >= K and 1 <= w <= 8, shape
    LR = L + R
    assert w == 1 if LR <= 16 else (w == 8 if LR > 512 else w > 1), shape


def _ctpf_pass_regime(K, L, R, dev, dtype):
    """ctpf_estep_pass's arguments on 24 documents of up to L token and R
    reader slots, in ``dtype``: document 0 has readers alone, 1 tokens
    alone, 2 no kept slot, the last 3 doc_mask 0; R = 0 drops the readers."""
    args = list(_ctpf_pass_args(_ctpf_chunk(K, 24, L, max(R, 1), 3000, 500, dev, seed=K + L)))
    if R == 0:
        args[4], args[5] = args[4][:, :0].contiguous(), args[5][:, :0].contiguous()
    else:
        args[3][0], args[2][0] = 0.0, 0                  # readers alone
        args[5][1], args[4][1] = 0.0, 0                  # tokens alone
        args[5][2], args[4][2] = 0.0, 0
    args[3][2], args[2][2] = 0.0, 0                      # no kept slot
    return tuple(a.to(dtype) if a.is_floating_point() else a for a in args)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("K", CTPF_PASS_K)
@pytest.mark.parametrize("L,R", CTPF_PASS_LR)
def test_ctpf_estep_pass_warp_mode_matches_plain(cuda, dtype, K, L, R):
    _check_ctpf_pass_shape(ctpf_estep_mod.pass_shape(L, R, K, dtype), L, R, K)
    args = _ctpf_pass_regime(K, L, R, cuda, dtype)
    n0, d0 = ctpf_estep_pass.launches, ctpf_estep_pass.launches_double
    got = ctpf_estep_pass(*args)
    torch.cuda.synchronize()
    assert (ctpf_estep_pass.launches, ctpf_estep_pass.launches_double) == (
        n0 + 1, d0 + (dtype == torch.float64))
    want = ctpf_estep_pass_ref(*args)
    tol = dict(rtol=5e-3, atol=1e-5) if dtype == torch.float32 else dict(rtol=RTOL64,
                                                                        atol=ATOL64)
    for name, a, b in zip(("gsum", "zsum"), got, want):
        assert a.dtype == dtype, name
        torch.testing.assert_close(a, b, **tol, msg=name)
        assert torch.all(a[-3:] == 0) and torch.all(a[2] == 0), name   # masked, nothing kept
    assert torch.all(got[0][0] != 0) and torch.all(got[1][1] == 0)   # readers, tokens alone
    if R > 0:
        assert torch.all(got[1][0] != 0)
    again = ctpf_estep_pass(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, again))   # bitwise repeatable


def test_ctpf_estep_pass_shape_choices(cuda):
    """The warp mode's (lanes a slot, vectors a lane, warps a document)
    over K and L + R in both dtypes: lanes 8, 16 or 32 whose vectors cover
    K, one warp for up to 16 slots, 8 past 512; lanes 0 past K = 512."""
    for dtype in (torch.float32, torch.float64):
        for K in (1, 32, 33, 64, 65, 100, 128, 129, 300, 512, 513, 3000):
            for L, R in ((4, 0), (7, 5), (40, 24), (64, 12), (129, 33), (384, 128), (900, 130)):
                G, nvl, w = ctpf_estep_mod.pass_shape(L, R, K, dtype)
                if K > 512:
                    assert G == 0, (K, L, R)
                    continue
                assert G in (8, 16, 32) and 1 <= nvl <= 4 and 4 * G * nvl >= K, (K, L, R, G, nvl)
                assert 4 * G * (nvl - 1) < K, (K, G, nvl)        # no vector wholly past K
                assert 1 <= w <= 8, (K, L, R, w)
                assert w == 1 if L + R <= 16 else (w == 8 if L + R > 512 else w > 1), (K, L, R, w)


@pytest.mark.parametrize("K,L", [(3, 13), (100, 129), (100, 1025)])
def test_flda_estep_at_viter_zero_keeps_the_state_and_writes_the_rows(cuda, K, L):
    """The split fixpoint's last call: no pass, the state returned as
    given, w from (tau_old, El_old) with the given tau's weights."""
    args = _flda_chunk(K, 24, L, 3000, cuda, seed=3)
    got = flda_estep(*args, viter=0, vtol=1.0 / K**2)
    for a, b in zip(got[:5], args[7:]):
        assert torch.equal(a, b)
    want = flda_estep_ref(*args, viter=0, vtol=1.0 / K**2)
    torch.testing.assert_close(got[5], want[5], rtol=5e-3, atol=1e-5)


@pytest.mark.parametrize("K,L,R", [(3, 13, 5), (100, 80, 24), (100, 601, 65)])
def test_ctpf_estep_at_viter_zero_keeps_the_state_and_writes_the_rows(cuda, K, L, R):
    args = _ctpf_chunk(K, 24, L, R, 3000, 500, cuda, seed=3)
    kw = dict(viter=0, vtol=1.0 / K**2, **HYP)
    got = ctpf_estep(*args, **kw)
    for a, b in zip(got[:4], args[10:]):
        assert torch.equal(a, b)
    want = ctpf_estep_ref(*args, **kw)
    for name, a, b in zip(("wa", "wh"), got[4:], want[4:]):
        torch.testing.assert_close(a, b, rtol=5e-3, atol=1e-5, msg=name)


def _refused(*a, **k):
    raise AssertionError("a CUDA tensor ran a plain version")


def test_flda_split_fixpoint_runs_the_kernels_and_never_the_plain_versions(cuda, monkeypatch):
    """On CUDA tensors fLDA's split fixpoint launches the pass kernel a
    pass and the E-step kernel once, and follows the plain fixpoint."""
    args = _flda_chunk(100, 48, 129, 3000, cuda, seed=9)
    want = flda_estep_ref(*args, viter=10, vtol=1e-4)
    monkeypatch.setattr(flda_estep_mod, "flda_estep_ref", _refused)
    monkeypatch.setattr(flda_estep_mod, "flda_estep_pass_ref", _refused)
    p0, e0 = flda_estep_pass.launches, flda_estep.launches
    got = flda_split_fixpoint(*args, viter=10, vtol=1e-4, reduce=lambda x: x)
    assert flda_estep_pass.launches - p0 >= 1 and flda_estep.launches - e0 == 1
    for name, a, b in zip(("gamma", "El", "El_old", "tau", "tau_old", "w"), got, want):
        torch.testing.assert_close(a, b, rtol=5e-3, atol=1e-5, msg=name)


def test_ctpf_split_fixpoint_runs_the_kernels_and_never_the_plain_versions(cuda, monkeypatch):
    args = _ctpf_chunk(100, 48, 80, 24, 3000, 500, cuda, seed=9)
    kw = dict(viter=10, vtol=1e-4, **HYP)
    want = ctpf_estep_ref(*args, **kw)
    monkeypatch.setattr(ctpf_estep_mod, "ctpf_estep_ref", _refused)
    monkeypatch.setattr(ctpf_estep_mod, "ctpf_estep_pass_ref", _refused)
    p0, e0 = ctpf_estep_pass.launches, ctpf_estep.launches
    got = ctpf_split_fixpoint(*args, **kw, reduce=lambda x: x)
    assert ctpf_estep_pass.launches - p0 >= 1 and ctpf_estep.launches - e0 == 1
    _ctpf_close(got, want)


@pytest.mark.parametrize("family", ["fLDA", "CTM", "fCTM", "CTPF"])
def test_seq_step_on_one_card_follows_the_dense_step(cuda, family):
    """A sequence-axis step with no mesh (the axis of one rank) runs the
    split path, through the pass kernels for fLDA and CTPF, and follows
    the dense step."""
    from topicmodelsvb_jl_torch.models import ctm, ctpf, fctm, flda

    mod = {"fLDA": flda, "CTM": ctm, "fCTM": fctm, "CTPF": ctpf}[family]
    K = 20
    if family == "CTPF":
        corp = tt.synth_corpus(M=512, V=600, U=80, K=5, seed=5, mean_readers=4)
        pk = tt.pack_corpus(corp, with_readers=True, docs_multiple=128)
    else:
        pk = tt.synth_packed_nsf_scale(M=512, V=600, mean_terms=30, seed=5)
    put = lambda a, dt: torch.as_tensor(np.asarray(a), dtype=dt, device=cuda)
    data = (put(pk.terms, torch.int32), put(pk.counts, torch.float32),
            put(pk.doc_mask, torch.float32))
    kw = dict(viter=10, vtol=1.0 / K**2, chunk_docs=128, device=cuda)
    if family == "CTPF":
        args = (data[0], data[1], put(pk.readers, torch.int32), put(pk.ratings, torch.float32),
                data[2])
    else:
        kw.update(niter=100, ntol=1.0 / K**2)
        args = (*data, float(pk.M))
        if family == "fLDA":
            args = (*data, torch.tensor(float(pk.M), device=cuda),
                    torch.tensor(float(pk.C.sum()), device=cuda))
    state = mod.init(torch.Generator().manual_seed(1), pk, K, device=cuda)
    want = mod.make_step(pk, K, **kw)(state, *args)
    launches = (flda_estep_pass if family == "fLDA" else ctpf_estep_pass).launches
    got = mod.make_step(pk, K, **kw, seq_axis="seq")(state, *args)
    for f in type(state).__dataclass_fields__:
        torch.testing.assert_close(getattr(got, f), getattr(want, f), rtol=5e-3, atol=1e-5,
                                   msg=f)
    if family in ("fLDA", "CTPF"):
        assert (flda_estep_pass if family == "fLDA" else ctpf_estep_pass).launches > launches
    e_want = mod.make_elbo(pk, K, 128)(got, *args[:5 if family == "CTPF" else 3])
    e_got = mod.make_elbo(pk, K, 128, seq_axis="seq")(got, *args[:5 if family == "CTPF" else 3])
    torch.testing.assert_close(e_got.double().sum(), e_want.double().sum(), rtol=1e-5, atol=0.0)


def _scatters(m):
    """Scatter launches per step of a model without readers: one per
    chunk whose plan keeps a slot."""
    return sum(q.n_pieces > 0 for q in token_plans(m.packed, m.chunk_docs, "cpu"))


def test_flda_and_ctpf_train_through_the_kernels(cuda):
    p = tt.synth_packed_nsf_scale(M=3000, V=800, mean_terms=40, seed=2)
    m = tt.fLDA(p, 16, tt.RuntimeConfig(chunk_docs=256), device=cuda, seed=1)
    e0, s0 = flda_estep.launches, scatter_rows.launches
    m.train(iter=3, checkelbo=1, printelbo=False)
    n_chunks = sum(s.terms.shape[0] for s in m.packed.segments) // m.chunk_docs
    assert flda_estep.launches - e0 == 3 * n_chunks
    assert scatter_rows.launches - s0 == 3 * _scatters(m)
    assert all(r.delta_elbo > 0 for r in m.trainer.trace[1:])
    corp = tt.synth_corpus(M=1500, V=600, K=8, U=300, seed=3, mean_tokens=40,
                           mean_terms=25, mean_readers=4)
    c = tt.CTPF(tt.pack_corpus(corp, with_readers=True), 16,
                tt.RuntimeConfig(chunk_docs=256), device=cuda, seed=1)
    e0 = ctpf_estep.launches
    c.train(iter=3, checkelbo=1, printelbo=False)
    n_chunks = sum(s.terms.shape[0] for s in c.packed.segments) // c.chunk_docs
    assert ctpf_estep.launches - e0 == 3 * n_chunks
    assert all(r.delta_elbo > 0 for r in c.trainer.trace[1:])
    assert sorted(c.drecs[0] + [u + 1 for u in c.packed.readers[c._rows(0), :c.R[0]]]) \
        == list(range(1, c.U + 1))


def test_ctm_and_fctm_train_through_the_kernels(cuda):
    """CTM's bound goes through lda_elbo_tok, both M-steps through the
    scatter; ∆elbo after the first is positive and sigma stays SPD."""
    p = tt.synth_packed_nsf_scale(M=3000, V=800, mean_terms=40, seed=2)
    for cls in (tt.CTM, tt.fCTM):
        m = cls(p, 12, tt.RuntimeConfig(chunk_docs=512), device=cuda, seed=1)
        k0, s0 = lda_elbo_tok.launches, scatter_rows.launches
        m.train(iter=3, checkelbo=1, printelbo=False)
        n_chunks = sum(s.terms.shape[0] for s in m.packed.segments) // m.chunk_docs
        assert scatter_rows.launches - s0 == 3 * _scatters(m)
        assert lda_elbo_tok.launches - k0 == (4 * n_chunks if cls is tt.CTM else 0)
        assert all(r.delta_elbo > 0 for r in m.trainer.trace[1:])
        assert np.all(np.linalg.eigvalsh(m.sigma.astype(np.float64)) > 0)


def test_cg_graph_blocks_match_eager(cuda, monkeypatch):
    """CG through replayed CUDA graphs of 4 iterations (and an eager tail
    when maxiter is not a multiple of 4) against the eager loop."""
    from topicmodelsvb_jl_torch.ops import newton

    r = np.random.default_rng(5)
    B, K = 512, 50
    t = lambda a, dt=torch.float32: torch.tensor(a, dtype=dt, device=cuda)
    a = r.normal(size=(K, K))
    invsigma = t(a @ a.T / K + np.eye(K))
    expo = t(r.uniform(0.1, 30.0, size=(B, K)))
    args = (invsigma, expo, t(r.normal(size=(B, K))),
            1.0 / (torch.diagonal(invsigma) + expo), t(r.random(B) < 0.9, torch.bool))
    for maxiter in (K + 8, 6, 3):
        graphed = newton.spd_cg_solve(*args, maxiter, 1e-5)
        assert torch.equal(graphed, newton.spd_cg_solve(*args, maxiter, 1e-5))
        with monkeypatch.context() as mp:
            mp.setattr(newton, "_cg_graphed", newton._cg_eager)
            eager = newton.spd_cg_solve(*args, maxiter, 1e-5)
        torch.testing.assert_close(graphed, eager, rtol=1e-4, atol=1e-6)
    assert sum(key[:2] == (B, K) for key in newton._CG_BLOCKS) == 1


def _corpus_split(M=3000, n_test=500):
    """(train, test) of one synthetic Corpus; the test documents keep
    only the terms some training document holds."""
    c = tt.synth_corpus(M=M, V=800, K=8, seed=2, mean_tokens=60, mean_terms=40)
    seen = {t for d in c.docs[:-n_test] for t in d.terms}
    test = [tt.Document(terms=[t for t in d.terms if t in seen],
                        counts=[n for t, n in zip(d.terms, d.counts) if t in seen])
            for d in c.docs[-n_test:]]
    return (tt.Corpus(docs=c.docs[:-n_test], vocab=dict(c.vocab)),
            tt.Corpus(docs=test, vocab=dict(c.vocab)))


def test_corpus_built_lda_first_step_card_vs_cpu(cuda):
    """A Corpus-built LDA's first step through the kernels (f32) against
    the plain versions on the CPU (f64), from one init."""
    from topicmodelsvb_jl_torch import convert

    train, _ = _corpus_split()
    gpu = tt.LDA(train, 16, tt.RuntimeConfig(chunk_docs=256), device=cuda, seed=1)
    cpu = tt.LDA(train, 16, tt.RuntimeConfig(chunk_docs=256, dtype="float64"), device="cpu")
    cpu.state = convert.lda_state_from_numpy(convert.lda_state_to_numpy(gpu.state), "cpu",
                                             torch.float64)
    e0 = lda_estep.launches
    for m in (gpu, cpu):
        m.train(iter=1, checkelbo=1, printelbo=False)
    n_chunks = sum(s.terms.shape[0] for s in gpu.packed.segments) // gpu.chunk_docs
    assert lda_estep.launches - e0 == n_chunks
    assert gpu.elbo == pytest.approx(cpu.elbo, rel=1e-4)
    for f in ("alpha", "beta", "gamma"):
        np.testing.assert_allclose(getattr(gpu, f), getattr(cpu, f), rtol=5e-3, atol=1e-5,
                                   err_msg=f)


@pytest.mark.parametrize("family", ["LDA", "fLDA"])
def test_predict_card_vs_cpu(cuda, family):
    """predict through the E-step kernel against the plain version on the
    CPU in f64, from one trained state; the globals stay bit for bit."""
    from topicmodelsvb_jl_torch import convert

    train, test = _corpus_split()
    to_np, from_np, kernel = {
        "LDA": (convert.lda_state_to_numpy, convert.lda_state_from_numpy, lda_estep),
        "fLDA": (convert.flda_state_to_numpy, convert.flda_state_from_numpy, flda_estep),
    }[family]
    gpu = getattr(tt, family)(train, 16, tt.RuntimeConfig(chunk_docs=256), device=cuda, seed=1)
    gpu.train(iter=3, checkelbo=float("inf"), printelbo=False)
    cpu = getattr(tt, family)(train, 16, tt.RuntimeConfig(chunk_docs=256, dtype="float64"),
                              device="cpu")
    cpu.state = from_np(to_np(gpu.state), "cpu", torch.float64)
    n0 = kernel.launches
    pg, pc = tt.predict(test, gpu, iter=10), tt.predict(test, cpu, iter=10)
    assert pg.device.type == "cuda" and pg.chunk_docs == 256
    assert kernel.launches - n0 == sum(s.terms.shape[0] for s in pg.packed.segments) // 256
    assert torch.equal(pg.state.beta, gpu.state.beta)
    assert torch.equal(pg.state.alpha, gpu.state.alpha)
    np.testing.assert_allclose(pg.gamma, pc.gamma, rtol=5e-3, atol=1e-5)
    td = pg.topicdist(np.arange(1, pg.M + 1))
    np.testing.assert_allclose(td.sum(-1), 1.0, atol=1e-5)


def test_model_without_device_lands_on_cuda(cuda):
    train, _ = _corpus_split(M=600, n_test=100)
    m = tt.LDA(train, 4, tt.RuntimeConfig(chunk_docs=128), seed=1)
    assert m.device.type == "cuda" and m.state.beta.is_cuda
    m.train(iter=2, checkelbo=1, printelbo=False)
    assert all(r.delta_elbo > 0 for r in m.trainer.trace)
    corp = tt.synth_corpus(M=300, V=200, K=4, U=40, seed=3, mean_tokens=30, mean_terms=20,
                           mean_readers=3)
    c = tt.CTPF(corp, 4, tt.RuntimeConfig(chunk_docs=128), seed=1)
    assert c.device.type == "cuda" and c.state.alef.is_cuda


def _stamped_corpus(M=600, V=300, K=4, T=5, seed=3):
    return tt.synth_corpus(M=M, V=V, K=K, seed=seed, n_slices=T, drift=0.2, mean_tokens=40,
                           mean_terms=25)


@pytest.mark.parametrize("W", [20, 41])
def test_scatter_rows_at_dtm_shapes(cuda, W):
    """DTM's M-step scatters: token rows into A [T·V, K] by slice·V + term
    (W = K = 20, mac's T = 12 and V = 15,113), and one row a document into
    [T, 2K + 1] by slice id."""
    T, V, B, L = 12, 15_113, 1024, 256
    r = np.random.default_rng(5)
    sid = r.integers(0, T, size=B)
    counts = (r.random((B, L)) < 0.85) * (1 + r.poisson(0.8, size=(B, L)))
    counts[-3:] = 0
    if W == 20:
        terms = np.minimum((V * r.random((B, L)) ** 3).astype(np.int64), V - 1)
        ids, keep, n_rows = sid[:, None] * V + terms, counts > 0, T * V
    else:
        ids, keep, n_rows = sid, np.arange(B) < B - 3, T
    w = r.random((ids.size, W)).astype(np.float32) * keep.reshape(-1, 1)
    plan = build_plan(ids, keep).to(cuda)
    wt = torch.tensor(w, device=cuda)
    acc = torch.rand((n_rows, W), device=cuda)
    n0 = scatter_rows.launches
    got = scatter_rows(acc.clone(), wt, plan)
    assert scatter_rows.launches == n0 + 1
    torch.testing.assert_close(got, scatter_rows_ref(acc.clone(), wt, plan), rtol=5e-3,
                               atol=1e-5)
    assert torch.equal(got, scatter_rows(acc.clone(), wt, plan))


def test_dtm_step_is_bitwise_repeatable_through_the_scatter(cuda):
    corp = _stamped_corpus()

    def run():
        m = tt.DTM(corp, 4, delta=1.0, runtime=tt.RuntimeConfig(chunk_docs=128), seed=2)
        n0 = scatter_rows.launches
        m.train(iter=1, checkelbo=float("inf"), printelbo=False, cgiter=4)
        torch.cuda.synchronize()
        return m, scatter_rows.launches - n0

    (a, na), (b, nb) = run(), run()
    assert a.device.type == "cuda" and a.state.betahat.is_cuda
    assert na == nb == 2 * (a.packed.M_pad // 128)
    for f in ("alpha", "betahat", "mbeta", "gamma", "Elogtheta", "lzeta"):
        assert torch.equal(getattr(a.state, f), getattr(b.state, f)), f


def test_checkpoint_card_to_cpu_and_back_is_bitwise(cuda, tmp_path):
    from topicmodelsvb_jl_torch import checkpoint as ckptlib

    corp = _stamped_corpus()
    for fam, kw in (("LDA", {}), ("DTM", {"delta": 1.0})):
        m = getattr(tt, fam)(corp, 4, runtime=tt.RuntimeConfig(chunk_docs=128), seed=1, **kw)
        m.train(iter=2, checkelbo=1, printelbo=False)
        snap = ckptlib.snapshot(m)
        assert snap[4] is not None and all(x.is_pinned() for x in snap[1].values())
        path = str(tmp_path / f"{fam}_card.npz")
        ckptlib.write_snapshot(path, snap)
        cpu = tt.load_checkpoint(path, corp, device="cpu")
        back_path = str(tmp_path / f"{fam}_cpu.npz")
        tt.save_checkpoint(back_path, cpu)
        back = tt.load_checkpoint(back_path, corp)
        assert back.device.type == "cuda" and back.trained_iters == 2
        for f in m._per_doc_fields + ("elbo",):
            assert torch.equal(getattr(cpu.state, f), getattr(m.state, f).cpu()), f
        for f, x in vars(m.state).items():
            assert torch.equal(getattr(back.state, f), x), f
    # a float64 checkpoint written on the CPU resumes on the card, for LDA
    # and for CTPF (whose ctpf_estep has a float64 mode too)
    rt64 = tt.RuntimeConfig(chunk_docs=128, dtype="float64")
    f64 = tt.LDA(corp, 4, rt64, device="cpu")
    f64.train(iter=1, checkelbo=1, printelbo=False)
    tt.save_checkpoint(str(tmp_path / "f64.npz"), f64)
    back64 = tt.load_checkpoint(str(tmp_path / "f64.npz"), corp)
    assert back64.device.type == "cuda" and back64.dtype == torch.float64
    for f, x in vars(f64.state).items():
        assert torch.equal(getattr(back64.state, f).cpu(), x), f
    c64 = tt.CTPF(corp, 4, rt64, device="cpu")
    c64.train(iter=1, checkelbo=1, printelbo=False)
    tt.save_checkpoint(str(tmp_path / "ctpf64.npz"), c64)
    cback = tt.load_checkpoint(str(tmp_path / "ctpf64.npz"), corp)
    assert cback.device.type == "cuda" and cback.dtype == torch.float64
    for f, x in vars(c64.state).items():
        assert torch.equal(getattr(cback.state, f).cpu(), x), f
    d0 = ctpf_estep.launches_double
    cback.train(iter=1, checkelbo=1, printelbo=False)
    assert ctpf_estep.launches_double > d0


def _hmtm_chunk(K, B, L, V, dev, seed=0):
    """hmtm_estep's arguments on one chunk: random table and state,
    documents of random lengths with trailing padding, an empty document
    (row 1), a one-token document (row 2), interior padding (row 3) and 3
    padded rows at the end (doc_mask 0)."""
    r = np.random.default_rng(seed)
    n = r.integers(1, L + 1, size=B)
    n[1], n[2] = 0, 1
    tmask = (np.arange(L)[None, :] < n[:, None]).astype(np.float32)
    tmask[3, : L // 3] = 0.0
    tmask[-3:] = 0.0
    terms = (V * r.random((B, L)) ** 3).astype(np.int32) * (tmask > 0)
    doc_mask = np.ones(B, np.float32)
    doc_mask[-3:] = 0.0
    t = lambda a, dt=torch.float32: torch.tensor(np.ascontiguousarray(a), dtype=dt, device=dev)
    return (t(r.dirichlet(np.ones(V), size=K).T + EPSILON), t(terms, torch.int32), t(tmask),
            t(doc_mask), t(r.uniform(0.5, 2.0, K)), t(r.uniform(0.5, 2.0, (K, K))),
            t(r.uniform(0.5, 3.0, (B, K))), t(r.uniform(0.5, 3.0, (B, K, K))))


def _hmtm_mode(L, K, suffix=""):
    import ctypes

    from topicmodelsvb_jl_torch.kernels import _build

    return _build.function(f"tmvb_hmtm_estep_mode{suffix}", [ctypes.c_int64] * 2)(L, K)


def _hmtm_counts():
    """The HMTM wrappers' wide and cluster launch counts."""
    return (hmtm_estep.launches_wide, hmtm_logz.launches_wide, hmtm_estep.launches_cluster,
            hmtm_logz.launches_cluster)


def _hmtm_counted(before, L, K, dtype, n=1, n_logz=None):
    """The counts ``n`` launches of hmtm_estep and ``n_logz`` (default
    ``n``) of hmtm_logz at (L, K) add to ``before``: the wide or the
    cluster mode's, as each wrapper's mode says."""
    from topicmodelsvb_jl_torch.kernels import hmtm_estep as hm

    nz = n if n_logz is None else n_logz
    m, lm = hm.mode(L, K, dtype), hm.logz_mode(L, K, dtype)
    return (before[0] + n * (m == hm.WIDE), before[1] + nz * (lm == hm.WIDE),
            before[2] + n * (m == hm.CLUSTER), before[3] + nz * (lm == hm.CLUSTER))


# K: NSF's 25 (the split schedule, register width 28), 1 and 32 (widths 16
# and 32), 40 and 100 (several warps), 200 (S in scratch); the cluster
# mode's 240, 256 and 300 (clusters of 2, hmtm_logz 2), 257 (more topics
# than a warp multiple), 400 (4; 4), 512 and 600 (8; 8), 680 (16; 16),
# 720 (hmtm_estep past its threads: the wide mode; hmtm_logz 16) and 1024
# (both kernels wide); L: NSF's widths, 1, 2 and
# 65 (the split's edges: no second half, one slot a half, an odd length),
# 1, 2 and 33 in the cluster mode (no step, one, odd) and 5000 (messages in
# scratch); viter 0 (the final pass only), 3 and 10
@pytest.mark.parametrize("K,L,viter", [(25, 128, 10), (25, 64, 0), (32, 24, 10), (40, 72, 3),
                                       (100, 128, 3), (200, 16, 3), (25, 5000, 2), (1, 40, 3),
                                       (240, 24, 3), (256, 24, 3), (257, 24, 3), (300, 24, 3),
                                       (512, 24, 3), (25, 1, 3), (25, 2, 3), (25, 65, 10),
                                       (300, 1, 3), (300, 2, 3), (300, 33, 10), (400, 24, 3),
                                       (600, 16, 3), (680, 12, 2), (720, 8, 1), (1024, 8, 1)])
def test_hmtm_estep_and_logz_kernels_match_plain(cuda, K, L, viter):
    B = 4 if K > 650 else (16 if L > 1000 or K > 256 else 64)
    args = _hmtm_chunk(K, B, L, 2000, cuda, seed=K + L)
    kw = dict(viter=viter, vtol=1.0 / K**2)
    e0, z0 = hmtm_estep.launches, hmtm_logz.launches
    w0 = _hmtm_counts()
    got = hmtm_estep(*args, **kw)
    torch.cuda.synchronize()
    assert hmtm_estep.launches == e0 + 1
    want = hmtm_estep_ref(*args, **kw)
    for name, a, b in zip(("tau", "gamma", "r"), got, want):
        torch.testing.assert_close(a, b, rtol=5e-3, atol=1e-5, msg=name)
    tmask = args[2]
    assert torch.all(got[2][tmask == 0] == 0)
    assert torch.equal(got[0][-3:], args[6][-3:]) and torch.equal(got[1][-3:], args[7][-3:])
    if viter == 0:
        assert torch.equal(got[0], args[6]) and torch.equal(got[1], args[7])
    assert all(torch.equal(a, b) for a, b in zip(got, hmtm_estep(*args, **kw)))
    zargs = (*args[:3], got[0], got[1])
    z = hmtm_logz(*zargs)
    assert hmtm_logz.launches == z0 + 1 and torch.equal(z, hmtm_logz(*zargs))
    assert _hmtm_counts() == _hmtm_counted(w0, L, K, torch.float32, 2)
    zr = hmtm_logz_ref(*zargs)
    assert float(z[1]) == 0.0 and torch.all(torch.isfinite(z))
    assert torch.all((z - zr).abs() <= 1e-5 * zr.abs())


@pytest.mark.parametrize("K", [25, 100, 300])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_hmtm_split_meets_on_padding_and_epsilon_emissions(cuda, dtype, K):
    """The split schedule's edges on the card (K = 25): every document's
    midpoint (last // 2) a padding slot, at several lengths; and documents
    whose last slot and midpoint hold a term no topic holds (emission
    EPSILON in every topic), where JAX's posteriors sum to less than 1 and
    logZ needs the forward's EPSILON through the backward.  The same
    documents in the multi-warp mode (K = 100) and the cluster mode (K =
    300), whose scalers add the port's EPSILON as the plain versions do."""
    B, L = 48, 40
    args = list(_hmtm_chunk(K, B, L, 500, cuda, seed=11))
    tmask, terms = args[2].clone(), args[1].clone()
    for d in range(4, 20):   # lengths 3 .. 40, the midpoint on padding
        last = 3 + (d - 4) * 37 // 15 - 1
        tmask[d] = 0.0
        tmask[d, : last + 1] = 1.0
        tmask[d, last // 2] = 0.0
    for d in range(20, 28):   # term 0, emission EPSILON, at the end and the middle
        last = 8 + 4 * (d - 20)
        tmask[d] = 0.0
        tmask[d, : last + 1] = 1.0
        terms[d, last] = terms[d, last // 2] = 0
    betaT = args[0].clone()
    betaT[0] = EPSILON
    args[0], args[1], args[2] = betaT, terms * (tmask > 0), tmask
    args = [a.to(dtype) if a.is_floating_point() else a for a in args]
    tol = dict(rtol=1e-9, atol=1e-12) if dtype == torch.float64 else dict(rtol=5e-3, atol=1e-5)
    kw = dict(viter=10, vtol=1.0 / K**2)
    got = hmtm_estep(*args, **kw)
    want = hmtm_estep_ref(*args, **kw)
    for name, a, b in zip(("tau", "gamma", "r"), got, want):
        torch.testing.assert_close(a, b, **tol, msg=name)
    assert torch.all(got[2][args[2] == 0] == 0)
    assert float(want[2][20:28].sum(-1).max()) < 0.99   # EPSILON moved the sums off 1
    zargs = (*args[:3], got[0], got[1])
    z, zr = hmtm_logz(*zargs), hmtm_logz_ref(*zargs)
    assert torch.all((z - zr).abs() <= (1e-12 if dtype == torch.float64 else 1e-5) * zr.abs())
    assert all(torch.equal(a, b) for a, b in zip(got, hmtm_estep(*args, **kw)))


def test_hmtm_shared_memory_rule_and_widest_k(cuda):
    """Messages in shared memory at the NSF widths, in scratch past them;
    S in scratch past K ~ 168; K = 239 the widest the chain matrix fits
    (H100's 227 KB opt-in) in float32, K = 169 in float64; past them, and
    past 256 topics, the cluster mode (4): clusters of 2, 4, 8 and 16, each
    CTA a block of A's rows; past its reach (hmtm_estep: K = 705 in float32,
    past its threads, and 638 in float64; hmtm_logz: K = 945 and 657) the
    wide mode (3).  Each side of each boundary runs and agrees with the
    plain version."""
    from topicmodelsvb_jl_torch.kernels import hmtm_estep as hm

    assert [_hmtm_mode(L, 25) for L in (64, 128, 5000)] == [0, 0, 1]
    assert _hmtm_mode(128, 100) == 1 and _hmtm_mode(128, 200) == 2
    assert _hmtm_mode(8, 239) == 2 and _hmtm_mode(8, 240) == 4
    assert [_hmtm_mode(8, K) for K in (256, 257, 704, 705, 4096)] == [4, 4, 4, 3, 3]
    assert _hmtm_mode(8, 169, "_f64") == 2 and _hmtm_mode(8, 170, "_f64") == 4
    assert _hmtm_mode(8, 637, "_f64") == 4 and _hmtm_mode(8, 638, "_f64") == 3
    assert _hmtm_mode(0, 25) == -2 and _hmtm_mode(8, 0) == -2
    f32, f64 = torch.float32, torch.float64
    width = lambda K, dt, logz=False: hm.cluster_width(8, K, dt, logz)
    assert ([width(K, f32) for K in (239, 240, 332, 333, 468, 469, 656, 657, 704, 705)]
            == [0, 2, 2, 4, 4, 8, 8, 16, 16, 0])
    assert ([width(K, f32, True) for K in (240, 336, 337, 475, 476, 670, 671, 944, 945)]
            == [2, 2, 4, 4, 8, 8, 16, 16, 0])
    assert ([width(K, f64) for K in (169, 170, 232, 233, 326, 327, 456, 457, 637, 638)]
            == [0, 2, 2, 4, 4, 8, 8, 16, 16, 0])
    assert [width(K, f64, True) for K in (170, 236, 237, 332, 333, 470, 471, 656, 657)] == [
        2, 2, 4, 4, 8, 8, 16, 16, 0]
    assert [hm.logz_mode(8, K) for K in (25, 239, 240, 944, 945)] == [0, 0, 4, 4, 3]
    for K, dt in ((239, f32), (240, f32), (704, f32), (705, f32), (169, f64), (170, f64),
                  (637, f64), (638, f64)):
        args = tuple(a.to(dt) if a.is_floating_point() else a for a in _hmtm_chunk(K, 4, 8, 300, cuda))
        w0 = _hmtm_counts()
        got = hmtm_estep(*args, viter=1, vtol=0.0)
        z = hmtm_logz(*args[:3], got[0], got[1])
        assert _hmtm_counts() == _hmtm_counted(w0, 8, K, dt)
        tol = dict(rtol=1e-9, atol=1e-12) if dt == f64 else dict(rtol=5e-3, atol=1e-5)
        torch.testing.assert_close(got[1], hmtm_estep_ref(*args, viter=1, vtol=0.0)[1], **tol)
        zr = hmtm_logz_ref(*args[:3], got[0], got[1])
        assert torch.all((z - zr).abs() <= (1e-9 if dt == f64 else 1e-5) * zr.abs())


def test_hmtm_kernels_reject_what_they_do_not_take(cuda):
    args = _hmtm_chunk(25, 16, 24, 100, cuda)
    kw = dict(viter=2, vtol=1e-3)
    with pytest.raises(TypeError, match="betaT_eps"):
        hmtm_estep(args[0].half(), *args[1:], **kw)
    with pytest.raises(TypeError, match="tmask must be torch.float64"):
        hmtm_estep(args[0].double(), *args[1:], **kw)
    with pytest.raises(TypeError, match="terms"):
        hmtm_estep(args[0], args[1].long(), *args[2:], **kw)
    with pytest.raises(ValueError, match="gamma"):
        hmtm_estep(*args[:7], args[7][:, :5].contiguous(), **kw)
    with pytest.raises(ValueError, match="alpha"):
        hmtm_estep(*args[:5], args[5].cpu(), *args[6:], **kw)
    with pytest.raises(ValueError, match="tmask"):
        hmtm_logz(args[0], args[1], args[2][:, :10].contiguous(), args[6], args[7])
    e0 = hmtm_estep.launches
    out = hmtm_estep(*(a[:0] if a.dim() and a.shape[0] == 16 else a for a in args), **kw)
    assert out[2].shape == (0, 24, 25) and hmtm_estep.launches == e0


def test_hmtm_trains_through_the_kernels(cuda):
    """The HMTM step launches hmtm_estep and the scatter once a chunk, the
    bound hmtm_logz once a chunk; ∆elbo after the first is positive; the
    card's f32 run stays near the CPU's f64 one from the same init."""
    from topicmodelsvb_jl_torch import convert
    from topicmodelsvb_jl_torch.ops.packing import unit_counts

    p = unit_counts(tt.synth_packed_nsf_scale(M=1500, V=600, mean_terms=40, seed=2))
    m = tt.HMTM(p, 10, tt.RuntimeConfig(chunk_docs=256), seed=1)
    assert m.device.type == "cuda" and m.state.beta.is_cuda
    cpu = tt.HMTM(p, 10, tt.RuntimeConfig(chunk_docs=256, dtype="float64"), device="cpu",
                  seed=1)
    cpu.state = convert.hmtm_state_from_numpy(convert.hmtm_state_to_numpy(m.state), "cpu",
                                              torch.float64)
    e0, z0, s0 = hmtm_estep.launches, hmtm_logz.launches, scatter_rows.launches
    m.train(iter=3, checkelbo=1, printelbo=False)
    cpu.train(iter=3, checkelbo=1, printelbo=False)
    n_chunks = sum(s.terms.shape[0] for s in m.packed.segments) // m.chunk_docs
    assert hmtm_estep.launches - e0 == 3 * n_chunks
    assert hmtm_logz.launches - z0 == 4 * n_chunks
    assert scatter_rows.launches - s0 == 3 * _scatters(m)
    assert all(r.delta_elbo > 0 for r in m.trainer.trace[1:])
    for a, b in zip(m.trainer.trace, cpu.trainer.trace):
        assert abs(a.elbo - b.elbo) <= 1e-4 * abs(b.elbo)
    for f in ("eta", "alpha", "beta"):
        np.testing.assert_allclose(getattr(m, f), getattr(cpu, f), rtol=1e-3, atol=1e-6,
                                   err_msg=f)


# ── host-streamed training (streaming.py) ──

def _stream_case(name, M=2000):
    """A small corpus, the constructor arguments and the train arguments
    of streaming ``name``.  DTM's is chip_smoke.py phase 8's small stamped
    corpus, its slices from the stamps, trained at cgiter = 5, cgtol = 0:
    at the default CG (20 iterations, cgtol = 1/T²) f32 and f64 runs part
    by 0.5-8% of betahat's norm within one iteration on the CPU alone, on
    this corpus and on one without time structure
    (tools/dtm_f32_error.py, stage 5)."""
    from topicmodelsvb_jl_torch.ops.packing import unit_counts

    if name == "StreamingCTPF":
        pk = tt.pack_corpus(tt.synth_corpus(M=M, V=600, K=8, U=300, seed=3, mean_tokens=40,
                                            mean_terms=25, mean_readers=4),
                            with_readers=True, docs_multiple=1024)
        return pk, {}, {}
    if name == "StreamingDTM":
        corp = tt.synth_corpus(M=M, V=600, K=8, seed=3, n_slices=5, drift=0.2, mean_tokens=60,
                               mean_terms=40)
        pk = tt.pack_corpus(corp, docs_multiple=1024)
        T, sid = tt.slices_from_stamps([d.stamp for d in corp.docs], 1.0, pk.M_pad)
        return pk, dict(T=T, slice_id=sid), dict(cgiter=5, cgtol=0.0)
    pk = tt.synth_packed_nsf_scale(M=M, V=800, mean_terms=30, seed=5, chunk_docs=1024)
    if name == "StreamingHMTM":
        return unit_counts(pk), {}, {}
    return pk, {}, {}


STREAMING = ["StreamingLDA", "StreamingFLDA", "StreamingCTPF", "StreamingCTM", "StreamingFCTM",
             "StreamingHMTM", "StreamingDTM"]


def _streamer(name, pk, ctor, dev, batch_docs=1024, dtype=torch.float32, **kw):
    return getattr(tt, name)(pk, 8, batch_docs=batch_docs, chunk_docs=256, dtype=dtype,
                             seed=1, device=dev, **ctor, **kw)


def _stream_equal(a, b, what):
    for n in a._globals:
        assert torch.equal(getattr(a, n), getattr(b, n)), f"{what}: {n}"
    for n in a._doc_state:
        assert np.array_equal(getattr(a, n), getattr(b, n)), f"{what}: {n}"
    assert a.trace == b.trace, what


@pytest.mark.parametrize("name", STREAMING)
def test_streamed_sweep_matches_plain_on_the_card(cuda, name):
    """One streamed sweep through the kernels on the card against the same
    sweep through the plain versions on the CPU, both f32 from one init."""
    from topicmodelsvb_jl_torch import convert

    pk, ctor, kw = _stream_case(name)
    card = _streamer(name, pk, ctor, cuda)
    cpu = _streamer(name, pk, ctor, "cpu")
    convert.streaming_from(cpu, card)
    card.train(iter=1, checkelbo=1, printelbo=False, **kw)
    cpu.train(iter=1, checkelbo=1, printelbo=False, **kw)
    for (_, a, _), (_, b, _) in zip(card.trace, cpu.trace):
        assert abs(a - b) <= 1e-5 * abs(b), (a, b)
    for n in card._globals:
        a, b = getattr(card, n).cpu(), getattr(cpu, n)
        if name == "StreamingDTM" and n in ("betahat", "mbeta"):
            # f32 rounding moves the CG's trial steps: by the norm
            assert float(torch.linalg.norm(a - b) / torch.linalg.norm(b)) <= 2e-3, n
        else:
            torch.testing.assert_close(a, b, rtol=5e-3, atol=1e-5, msg=n)
    for n in card._doc_state:
        torch.testing.assert_close(torch.as_tensor(getattr(card, n)),
                                   torch.as_tensor(getattr(cpu, n)), rtol=5e-3, atol=1e-5,
                                   msg=n)


@pytest.mark.parametrize("name", STREAMING)
def test_streaming_is_bitwise_repeatable_and_batch_invariant_on_the_card(cuda, name):
    pk, ctor, kw = _stream_case(name)
    runs = []
    for batch in (1024, 1024, 2048):
        m = _streamer(name, pk, ctor, cuda, batch_docs=batch)
        m.train(iter=2, checkelbo=1, printelbo=False, **kw)
        runs.append(m)
    _stream_equal(runs[1], runs[0], f"{name}: same seed")
    _stream_equal(runs[2], runs[0], f"{name}: batch_docs 2048 against 1024")


@pytest.mark.parametrize("name", STREAMING)
def test_streaming_checkpoint_resume_on_the_card(cuda, name, tmp_path):
    pk, ctor, kw = _stream_case(name)
    ref = _streamer(name, pk, ctor, cuda)
    ref.train(iter=3, checkelbo=1, printelbo=False, **kw)
    half = _streamer(name, pk, ctor, cuda)
    half.train(iter=2, checkelbo=1, printelbo=False, **kw)
    half.save(str(tmp_path / "s.npz"))
    back = tt.load_streaming_checkpoint(str(tmp_path / "s.npz"), pk)
    assert back.device.type == "cuda" and back.trained_iters == 2
    back.train(iter=1, checkelbo=1, printelbo=False, **kw)
    _stream_equal(back, ref, f"{name}: resume")


@pytest.mark.parametrize("name", STREAMING)
def test_streaming_device_memory_does_not_grow_with_the_corpus(cuda, name):
    """O(batch): the peak device memory of a sweep at one batch size is the
    same for a corpus four times as large."""
    peaks = []
    for M in (2000, 8000):
        pk, ctor, kw = _stream_case(name, M=M)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        m = _streamer(name, pk, ctor, cuda)
        m.train(iter=1, checkelbo=1, printelbo=False, **kw)
        torch.cuda.synchronize()
        peaks.append(torch.cuda.max_memory_allocated() - base)
        del m
    assert peaks[1] <= 1.1 * peaks[0] + 2**20, peaks


def test_streaming_float64_on_cuda_raises(cuda):
    """float16 on the card is refused before anything is built; float64
    runs there for StreamingCTPF and StreamingHMTM (one sweep, through
    their kernels' float64 modes) as for StreamingLDA."""
    for name, kernel in (("StreamingCTPF", ctpf_estep), ("StreamingHMTM", hmtm_estep)):
        pk, ctor, kw = _stream_case(name)
        with pytest.raises(TypeError, match="in float16 on CUDA"):
            _streamer(name, pk, ctor, cuda, dtype="float16")
        m = _streamer(name, pk, ctor, cuda, dtype=torch.float64)
        d0 = kernel.launches_double
        m.train(iter=1, checkelbo=1, printelbo=False, **kw)
        assert m.dtype == torch.float64 and kernel.launches_double > d0
        assert np.all(np.isfinite([e for _, e, _ in m.trace]))
    pk, _, _ = _stream_case("StreamingLDA")
    assert tt.StreamingLDA(pk, 8, dtype=torch.float64, device=cuda).dtype == torch.float64


_TWO_RANKS = r"""
import os, sys
import numpy as np
import torch
from topicmodelsvb_jl_torch.parallel import multihost
rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
multihost.initialize(f"localhost:{port}", 2, rank, backend="gloo")
import topicmodelsvb_jl_torch as tt
from topicmodelsvb_jl_torch.kernels.lda_estep import lda_estep
m = tt.LDA(tt.synth_packed_nsf_scale(M=3000, V=800, mean_terms=30, seed=2), 8, seed=1)
assert m.device.type == "cuda" and m._n_shards == 2
lda_estep.launches = 0
m.train(iter=2, checkelbo=1, printelbo=False)
np.savez(os.path.join(out, f"r{rank}.npz"), beta=m.state.beta.cpu().numpy(),
         alpha=m.state.alpha.cpu().numpy(), launches=lda_estep.launches,
         trace=np.array([r.elbo for r in m.trainer.trace]))
"""


def test_two_gloo_ranks_share_the_card(cuda, tmp_path):
    """Two processes of a gloo group on the one card: LDA with no device=
    and no mesh= shards over them, each launches its kernels, and the two
    agree bit for bit and with one process to the f32 tolerance."""
    import os
    import socket
    import subprocess
    import sys

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [subprocess.Popen([sys.executable, "-c", _TWO_RANKS, str(r), str(port),
                               str(tmp_path)], cwd=root, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in range(2)]
    try:
        for p in procs:
            _, err = p.communicate(timeout=300)
            assert p.returncode == 0, err[-4000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    r0, r1 = (np.load(tmp_path / f"r{r}.npz") for r in range(2))
    for f in ("beta", "alpha", "trace"):
        np.testing.assert_array_equal(r0[f], r1[f])
    assert int(r0["launches"]) > 0 and int(r1["launches"]) > 0
    one = tt.LDA(tt.synth_packed_nsf_scale(M=3000, V=800, mean_terms=30, seed=2), 8, seed=1)
    one.train(iter=2, checkelbo=1, printelbo=False)
    np.testing.assert_allclose(r0["beta"], one.beta, rtol=5e-3, atol=1e-5)
    np.testing.assert_allclose(r0["alpha"], one.alpha, rtol=5e-3, atol=1e-5)
    np.testing.assert_allclose(r0["trace"], [r.elbo for r in one.trainer.trace], rtol=1e-5)


# ── the f64 Elogtheta channel: a mode of lda_estep and flda_estep ──

# rows in shared memory and in tiles; K % 4 != 0; wider than the block
@pytest.mark.parametrize("K,L", [(100, 128), (101, 64), (100, 1024), (257, 24), (1, 8)])
def test_lda_estep_f64_mode_matches_plain(cuda, K, L):
    """The f64-channel mode against the plain version's float64 psi: the
    psi of both is exact to ~1e-14 before the cast, so El is held tighter
    than the f32 mode (rtol 1e-5); bitwise repeatable; padded documents
    frozen; it launches the kernel and differs from the f32 mode."""
    args, _ = _chunk(K, 64, L, 3000, cuda, seed=3)
    kw = dict(viter=10, vtol=1.0 / K**2)
    before = lda_estep.launches
    got = lda_estep(*args, **kw, elogtheta_f64=True)
    torch.cuda.synchronize()
    assert lda_estep.launches == before + 1
    want = lda_estep_ref(*args, **kw, elogtheta_f64=True)
    for name, a, b in zip(("gamma", "El", "El_old", "w"), got, want):
        torch.testing.assert_close(a, b, rtol=5e-3, atol=1e-5, msg=name)
    torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=1e-6)
    for a, b in zip(got[:3], args[5:]):
        assert torch.equal(a[-3:], b[-3:])
    again = lda_estep(*args, **kw, elogtheta_f64=True)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    if K > 1:
        assert not torch.equal(got[1], lda_estep(*args, **kw)[1])


@pytest.mark.parametrize("K,L", [(100, 128), (7, 24), (100, 1024), (160, 40)])
def test_flda_estep_f64_mode_matches_plain(cuda, K, L):
    args = _flda_chunk(K, 64, L, 3000, cuda, seed=5)
    kw = dict(viter=10, vtol=1.0 / K**2)
    before = flda_estep.launches
    got = flda_estep(*args, **kw, elogtheta_f64=True)
    torch.cuda.synchronize()
    assert flda_estep.launches == before + 1
    want = flda_estep_ref(*args, **kw, elogtheta_f64=True)
    for name, a, b in zip(("gamma", "El", "El_old", "tau", "tau_old", "w"), got, want):
        torch.testing.assert_close(a, b, rtol=5e-3, atol=1e-5, msg=name)
    for a, b in zip(got[:5], args[7:]):
        assert torch.equal(a[-3:], b[-3:])
    again = flda_estep(*args, **kw, elogtheta_f64=True)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert not torch.equal(got[1], flda_estep(*args, **kw)[1])


@pytest.mark.parametrize("viter", [0, 3])
def test_f64_modes_special_documents(cuda, viter):
    """A masked document with counts and a real one with none, in both
    kernels' f64 modes."""
    (betaT, terms, counts, doc_mask, *rest), _ = _chunk(100, 16, 128, 3000, cuda, seed=4)
    doc_mask[0] = 0.0
    counts[1] = 0.0
    args = (betaT, terms, counts, doc_mask, *rest)
    got = lda_estep(*args, viter=viter, vtol=1e-4, elogtheta_f64=True)
    want = lda_estep_ref(*args, viter=viter, vtol=1e-4, elogtheta_f64=True)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=5e-3, atol=1e-5)
    fargs = list(_flda_chunk(100, 16, 128, 3000, cuda, seed=4))
    fargs[4][0] = 0.0
    fargs[3][1] = 0.0
    got = flda_estep(*fargs, viter=viter, vtol=1e-4, elogtheta_f64=True)
    want = flda_estep_ref(*fargs, viter=viter, vtol=1e-4, elogtheta_f64=True)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=5e-3, atol=1e-5)


def test_lda_and_flda_train_with_elogtheta_f64_on_the_card(cuda):
    """RuntimeConfig(elogtheta_f64=True) goes through the kernels' f64
    modes (never the plain versions), the bound rises, and the split
    fixpoint's f64 tiles follow the fused mode."""
    from topicmodelsvb_jl_torch.models.lda import _chunks

    pk = tt.synth_packed_nsf_scale(M=3000, V=800, mean_terms=30, seed=2)
    rt = tt.RuntimeConfig(elogtheta_f64=True)
    for cls, kern in ((tt.LDA, lda_estep), (tt.fLDA, flda_estep)):
        m = cls(pk, 16, rt, device=cuda, seed=1)
        kern.launches = 0
        m.train(iter=3, checkelbo=1, printelbo=False)
        assert kern.launches == 3 * len(_chunks(m.local_packed, m.chunk_docs))
        assert all(r.delta_elbo > 0 for r in m.trainer.trace[1:])
    args, _ = _chunk(100, 48, 129, 3000, cuda, seed=9)
    want = lda_estep(*args, viter=10, vtol=1e-4, elogtheta_f64=True)
    got = split_fixpoint(*args, viter=10, vtol=1e-4, reduce=lambda x: x, elogtheta_f64=True)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=5e-3, atol=1e-5)


def test_cli_on_the_card(cuda, tmp_path):
    """The CLI at a small size on the card: an MFU from the card's own
    peak, a profiler trace with CUDA kernels, and its refusals."""
    import json
    import os

    from topicmodelsvb_jl_torch import train

    prof = str(tmp_path / "prof")
    s = train.run(["--model", "lda", "--corpus", "nsf-scale", "--subset", "4096", "--k", "20",
                   "--iter", "5", "--quiet", "--profile-dir", prof, "--elogtheta-f64"])
    assert 0 < s["mfu"] <= 1 and s["flops_per_step"] > 0
    (name,) = os.listdir(prof)
    with open(os.path.join(prof, name)) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert "cavi_step" in names
    assert any("lda_estep_kernel" in n for n in names)
    with pytest.raises(SystemExit, match="no plain E-step"):
        train.run(["--corpus", "synth", "--k", "3", "--model", "lda", "--no-pallas"])
    d0 = ctpf_estep.launches_double
    s = train.run(["--corpus", "synth", "--k", "3", "--model", "ctpf", "--dtype", "float64",
                   "--iter", "2", "--checkelbo", "1", "--quiet"])
    assert ctpf_estep.launches_double > d0 and np.isfinite(s["final_elbo"])


# ── the float64 modes of scatter_rows, lda_estep, lda_elbo_tok, flda_estep ──

RTOL64, ATOL64 = 1e-9, 1e-12   # float64 kernel against its plain version


def _f64(args):
    """The same arguments with every float tensor in float64."""
    return tuple(a.double() if torch.is_floating_point(a) else a for a in args)


def _close64(got, want, names):
    for name, a, b in zip(names, got, want):
        assert a.dtype == torch.float64, name
        torch.testing.assert_close(a, b, rtol=RTOL64, atol=ATOL64, msg=name)


# the main path's widest chunk (1024 documents, L = 128, K = 100), K % 4
# != 0, rows in tiles (L = 1024), and wider than the block (K = 257)
F64_SHAPES = [(1024, 128, 100), (64, 64, 101), (64, 1024, 100), (16, 40, 257)]


@pytest.mark.parametrize("B,L,K", F64_SHAPES)
def test_lda_estep_double_matches_plain(cuda, B, L, K):
    args = _f64(_chunk(K, B, L, 25_000, cuda)[0])
    n0, d0 = lda_estep.launches, lda_estep.launches_double
    got = lda_estep(*args, viter=10, vtol=1.0 / K**2)
    torch.cuda.synchronize()
    assert (lda_estep.launches, lda_estep.launches_double) == (n0 + 1, d0 + 1)
    _close64(got, lda_estep_ref(*args, viter=10, vtol=1.0 / K**2), ("gamma", "El", "El_old", "w"))
    assert torch.all(got[3][-3:] == 0)   # zeros on masked documents
    for a, b in zip(got[:3], args[5:]):
        assert torch.equal(a[-3:], b[-3:])
    assert all(torch.equal(a, b) for a, b in zip(got, lda_estep(*args, viter=10, vtol=1.0 / K**2)))
    # the f64 Elogtheta channel is the identity on a float64 state
    ch = lda_estep(*args, viter=10, vtol=1.0 / K**2, elogtheta_f64=True)
    assert all(torch.equal(a, b) for a, b in zip(ch, got))


@pytest.mark.parametrize("B,L,K", F64_SHAPES)
def test_flda_estep_double_matches_plain(cuda, B, L, K):
    args = _f64(_flda_chunk(K, B, L, 25_000, cuda))
    n0, d0 = flda_estep.launches, flda_estep.launches_double
    got = flda_estep(*args, viter=10, vtol=1.0 / K**2)
    torch.cuda.synchronize()
    assert (flda_estep.launches, flda_estep.launches_double) == (n0 + 1, d0 + 1)
    names = ("gamma", "El", "El_old", "tau", "tau_old", "w")
    _close64(got, flda_estep_ref(*args, viter=10, vtol=1.0 / K**2), names)
    assert torch.all(got[5][-3:] == 0)
    for a, b in zip(got[:5], args[7:]):
        assert torch.equal(a[-3:], b[-3:])
    assert all(torch.equal(a, b) for a, b in zip(got, flda_estep(*args, viter=10, vtol=1.0 / K**2)))
    ch = flda_estep(*args, viter=10, vtol=1.0 / K**2, elogtheta_f64=True)
    assert all(torch.equal(a, b) for a, b in zip(ch, got))


# flda_estep's float64 mode: the resident design at the widest NSF chunk
# (L = 128), an odd K, one topic, K = 129 and 512 (16 and 32 lanes a
# slot), 256 slots at K = 100 (one block an SM), and the block kernel past
# it (L = 1024 in tiles; K = 600 past the design's reach); each at viter
# 10 and 0, with a masked document, a real one with no kept slot and one
# whose slots all keep a count
FLDA64_CASES = [(1024, 128, 100, "resident"), (64, 64, 101, "resident"), (32, 40, 1, "resident"),
                (32, 40, 129, "resident"), (16, 24, 512, "resident"),
                (64, 256, 100, "resident"), (64, 1024, 100, "tiled"), (16, 40, 600, None)]


@pytest.mark.parametrize("viter", [10, 0])
@pytest.mark.parametrize("B,L,K,design", FLDA64_CASES)
def test_flda_estep_double_designs_match_plain(cuda, B, L, K, design, viter):
    shape = flda_estep_mod.double_shape(L, K)
    if design is not None:
        assert shape["design"] == design, shape
    assert shape["blocks"] >= 1, shape
    if (L, K) == (128, 100):
        assert shape["blocks"] == 2, shape   # two documents an SM at the widest NSF chunk
    args = list(_f64(_flda_chunk(K, B, L, 25_000, cuda, seed=K + L)))
    args[3][1] = 0.0                                   # a real document with no kept slot
    args[3][2] = torch.where(args[3][2] > 0, args[3][2], torch.ones_like(args[3][2]))
    args[2][2] = torch.where(args[3][2] > 0, args[2][2], torch.full_like(args[2][2], 11))
    kw = dict(viter=viter, vtol=1.0 / K**2)
    n0, d0 = flda_estep.launches, flda_estep.launches_double
    got = flda_estep(*args, **kw)
    torch.cuda.synchronize()
    assert (flda_estep.launches, flda_estep.launches_double) == (n0 + 1, d0 + 1)
    _close64(got, flda_estep_ref(*args, **kw), ("gamma", "El", "El_old", "tau", "tau_old", "w"))
    assert torch.all(got[5][-3:] == 0) and torch.all(got[5][1] == 0)
    for a, b in zip(got[:5], args[7:]):
        assert torch.equal(a[-3:], b[-3:])             # masked documents frozen
        if viter == 0:
            assert torch.equal(a, b)                   # no pass: the state as given
    if viter:
        assert not torch.equal(got[3][1], args[10][1])   # no kept slot: tau still moves
    assert all(torch.equal(a, b) for a, b in zip(got, flda_estep(*args, **kw)))


# lda_estep's float64 mode: the resident design at the widest NSF chunk
# (L = 128, two documents an SM), each side of its lanes' steps (K = 1,
# 33, 64, 65, 100, 101, 104, 105, 112, 113, 128, 129, 256, 512: 8 lanes of
# 4, 8 or 13 topics, 16 lanes of 8, 32 lanes of 8 or 16; one or two slots a
# group), 256 slots at K = 100 (one block an SM),
# and the block kernel past it (L = 1024 in tiles; K = 600 past the
# design's reach); each at viter 10 and 0, with masked documents (the last
# three without counts, one with them), a real one with no kept slot and
# one whose slots all keep a count
LDA64_CASES = [(1024, 128, 100, "resident"), (32, 40, 1, "resident"), (32, 40, 33, "resident"),
               (32, 40, 64, "resident"), (32, 40, 65, "resident"), (64, 64, 101, "resident"),
               (32, 40, 104, "resident"), (32, 40, 105, "resident"), (32, 40, 112, "resident"),
               (32, 40, 113, "resident"), (32, 40, 128, "resident"), (32, 40, 129, "resident"),
               (16, 24, 256, "resident"), (16, 24, 512, "resident"), (64, 256, 100, "resident"),
               (64, 1024, 100, "tiled"), (16, 40, 600, None)]


@pytest.mark.parametrize("viter", [10, 0])
@pytest.mark.parametrize("B,L,K,design", LDA64_CASES)
def test_lda_estep_double_designs_match_plain(cuda, B, L, K, design, viter):
    shape = lda_estep_mod.double_shape(L, K)
    if design is not None:
        assert shape["design"] == design, shape
    assert shape["blocks"] >= 1, shape
    if (L, K) == (128, 100):
        assert shape["blocks"] == 2, shape   # two documents an SM at the widest NSF chunk
    args = list(_f64(_chunk(K, B, L, 25_000, cuda, seed=K + L)[0]))
    args[2][1] = 0.0                                   # a real document with no kept slot
    args[2][2] = torch.where(args[2][2] > 0, args[2][2], torch.ones_like(args[2][2]))
    args[1][2] = torch.where(args[2][2] > 0, args[1][2], torch.full_like(args[1][2], 11))
    args[3][3] = 0.0                                   # masked, with its counts
    kw = dict(viter=viter, vtol=1.0 / K**2)
    n0, d0 = lda_estep.launches, lda_estep.launches_double
    got = lda_estep(*args, **kw)
    torch.cuda.synchronize()
    assert (lda_estep.launches, lda_estep.launches_double) == (n0 + 1, d0 + 1)
    _close64(got, lda_estep_ref(*args, **kw), ("gamma", "El", "El_old", "w"))
    assert torch.all(got[3][-3:] == 0) and torch.all(got[3][1] == 0)
    assert torch.all(got[3][3][args[2][3] > 0] > 0)   # a masked document's rows from El_old
    for a, b in zip(got[:3], args[5:]):
        assert torch.equal(a[-3:], b[-3:]) and torch.equal(a[3], b[3])   # masked: frozen
        if viter == 0:
            assert torch.equal(a, b)                   # no pass: the state as given
    if viter:
        assert not torch.equal(got[0][1], args[5][1])   # no kept slot: gamma still moves
    assert all(torch.equal(a, b) for a, b in zip(got, lda_estep(*args, **kw)))


def test_flda_estep_double_widest_k(cuda):
    """The float64 mode's widest K at L = 4 still runs (the block kernel)
    and one past it is refused, as before the resident design."""
    K = _k_past_f64_limit("flda_estep")
    args = _f64(_flda_chunk(K - 500, 4, 4, 10, cuda))
    assert flda_estep_mod.double_shape(4, K - 500)["design"] in ("tiled", "block-resident")
    got = flda_estep(*args, viter=2, vtol=1e-3)
    _close64(got, flda_estep_ref(*args, viter=2, vtol=1e-3),
             ("gamma", "El", "El_old", "tau", "tau_old", "w"))
    with pytest.raises(RuntimeError, match="does not fit"):
        flda_estep(*_f64(_flda_chunk(K, 4, 4, 10, cuda)), viter=2, vtol=1e-3)


@pytest.mark.parametrize("B,L,K", F64_SHAPES)
def test_lda_elbo_tok_double_matches_plain(cuda, B, L, K):
    _, eargs = _chunk(K, B, L, 25_000, cuda)
    eargs = _f64(eargs)
    n0, d0 = lda_elbo_tok.launches, lda_elbo_tok.launches_double
    got = lda_elbo_tok(*eargs)
    torch.cuda.synchronize()
    assert (lda_elbo_tok.launches, lda_elbo_tok.launches_double) == (n0 + 1, d0 + 1)
    want = lda_elbo_tok_ref(*eargs)
    assert got.dtype == torch.float64
    assert abs(float(got) - float(want)) <= RTOL64 * abs(float(want))
    assert torch.equal(got, lda_elbo_tok(*eargs))
    # masked documents add nothing
    dm = eargs[4].clone()
    dm[: B // 2] = 0
    part = lda_elbo_tok(*eargs[:4], dm, *eargs[5:])
    keep = lda_elbo_tok_ref(*(a[B // 2:] if a.dim() and a.shape[0] == B else a for a in eargs))
    assert abs(float(part) - float(keep)) <= RTOL64 * abs(float(keep))


# W: DTM's K = 20 and 2K + 1 = 41, LDA's 100 and fLDA's 101, and each side
# of the float64 design's lanes a row (G = 2, 4, 8, 16 for up to 8, 16,
# 32, 64 vectors: double2 where W is even, doubles where it is odd; past
# 64 vectors a warp a piece, the float32 mode's design, past 128 of them
# two passes over the rows); runs of 16 and 17 rows (each side of a CTA a
# piece, LONG_ROWS) and of 256 and 257 rows (each side of a split run,
# PIECE_ROWS) beside the random ones
@pytest.mark.parametrize("W", [1, 7, 9, 16, 18, 20, 32, 34, 41, 63, 64, 65, 66, 100, 101, 128,
                               130, 257, 258])
def test_scatter_rows_double_matches_plain(cuda, W):
    from topicmodelsvb_jl_torch.kernels.scatter_rows import LONG_ROWS, PIECE_ROWS

    r = np.random.default_rng(9)
    T, B, L = 12 * 15_113 if W == 20 else 25_000, 1024, 128 if W <= 130 else 16
    ids = (T * r.random((B, L)) ** 3).astype(np.int32)
    keep = r.random((B, L)) < 0.8
    ids[:, 0] = 7   # one long run: split pieces and the second launch
    flat, kflat, at = ids.reshape(-1), keep.reshape(-1), B
    for j, n in enumerate((LONG_ROWS, LONG_ROWS + 1, PIECE_ROWS, PIECE_ROWS + 1)):
        flat[at:at + n], kflat[at:at + n] = T + j, True
        at += n
    plan = build_plan(ids, keep).to(cuda)
    assert 0 < plan.n_long < plan.n_pieces and plan.run_id.shape[0] > 0
    w = torch.tensor(r.random((B * L, W)) * keep.reshape(-1, 1), dtype=torch.float64,
                     device=cuda)
    acc = torch.tensor(r.random((T + 4, W)), dtype=torch.float64, device=cuda)
    n0, d0 = scatter_rows.launches, scatter_rows.launches_double
    got = scatter_rows(acc.clone(), w, plan)
    torch.cuda.synchronize()
    assert (scatter_rows.launches, scatter_rows.launches_double) == (n0 + 1, d0 + 1)
    torch.testing.assert_close(got, scatter_rows_ref(acc.clone(), w, plan), rtol=RTOL64,
                               atol=ATOL64)
    assert torch.equal(got, scatter_rows(acc.clone(), w, plan))
    # a row 8 bytes off 16-byte alignment takes the double lanes
    if W % 2 == 0:
        w8 = torch.empty(B * L * W + 1, dtype=torch.float64, device=cuda)[1:].view(B * L, W)
        w8.copy_(w)
        torch.testing.assert_close(scatter_rows(acc.clone(), w8, plan), got, rtol=RTOL64,
                                   atol=ATOL64)
    with pytest.raises(TypeError, match="weights"):
        scatter_rows(acc.clone(), w.float(), plan)


@pytest.mark.parametrize("W", [20, 41])
def test_scatter_rows_double_at_dtm_shapes(cuda, W):
    """DTM's float64 M-step scatters at the mac shape: A's rows (W = K =
    20, ids slice·V + term, ~2 rows a piece) and the per-slice rows (W =
    2K + 1 = 41, 12 slice ids over 1024 documents, one slice holding more
    than 256 of them: a split run) against the plain version, bitwise
    repeatable, one launch counted in ``launches_double``."""
    T, V, B, L = 12, 15_113, 1024, 320
    r = np.random.default_rng(23)
    sid = r.integers(0, T, size=B)
    if W == 20:
        # ~225 terms a document, most from its topic's band of the vocabulary
        n = r.integers(150, 300, size=B)
        keep = np.arange(L)[None, :] < n[:, None]
        band, z = V // 20, r.integers(0, 20, size=B)
        terms = (z[:, None] * band + (band * r.random((B, L)) ** 2).astype(np.int64)) % V
        ids, n_rows = sid[:, None] * V + terms, T * V
    else:
        sid[:300] = 5   # a run past PIECE_ROWS
        ids, keep, n_rows = sid, np.ones(B, bool), T
    plan = build_plan(ids, keep).to(cuda)
    if W == 20:   # ~2 rows a piece, some past LONG_ROWS, no split run
        assert 1.5 < plan.rows.shape[0] / plan.n_pieces < 3 and plan.run_id.shape[0] == 0
        assert 0 < plan.n_long < plan.n_pieces
    else:
        assert plan.n_pieces >= 12 and plan.run_id.shape[0] == 1
    w = torch.tensor(r.random((ids.size, W)) * keep.reshape(-1, 1), dtype=torch.float64,
                     device=cuda)
    acc = torch.tensor(r.random((n_rows, W)), dtype=torch.float64, device=cuda)
    n0, d0 = scatter_rows.launches, scatter_rows.launches_double
    got = scatter_rows(acc.clone(), w, plan)
    torch.cuda.synchronize()
    assert (scatter_rows.launches, scatter_rows.launches_double) == (n0 + 1, d0 + 1)
    torch.testing.assert_close(got, scatter_rows_ref(acc.clone(), w, plan), rtol=RTOL64,
                               atol=ATOL64)
    assert all(torch.equal(got, scatter_rows(acc.clone(), w, plan)) for _ in range(3))


def _k_past_f64_limit(name):
    """A K whose rows fit shared memory in float32 but not in float64."""
    import ctypes

    from topicmodelsvb_jl_torch.kernels import _build

    q = lambda sfx: _build.function(f"tmvb_{name}_scratch{sfx}", [ctypes.c_int64] * 2,
                                    ctypes.c_int64)
    for K in range(2000, 20_001, 500):
        if q("")(4, K) >= 0 and q("_f64")(4, K) < 0:
            return K
    raise AssertionError(f"{name}: no K between the float32 and float64 limits")


def test_double_kernels_raise_past_their_k_limit(cuda):
    """Past the float64 K limit each kernel raises; the float32 mode takes
    the same K.  No plain version is handed the work."""
    for name, fn, chunk in (("lda_estep", lda_estep, lambda K: _chunk(K, 2, 4, 10, cuda)[0]),
                            ("flda_estep", flda_estep, lambda K: _flda_chunk(K, 4, 4, 10, cuda))):
        K = _k_past_f64_limit(name)
        args = chunk(K)
        fn(*args, viter=2, vtol=1e-3)
        n0 = fn.launches
        with pytest.raises(RuntimeError, match="does not fit"):
            fn(*_f64(args), viter=2, vtol=1e-3)
        assert fn.launches == n0
    _, eargs = _chunk(20_000, 4, 4, 10, cuda)
    lda_elbo_tok(*eargs)
    with pytest.raises(RuntimeError, match="lda_elbo_tok"):
        lda_elbo_tok(*_f64(eargs))


@pytest.mark.parametrize("fam", ["LDA", "DTM"])
def test_double_model_on_the_card_follows_the_cpu(cuda, fam):
    """A float64 LDA and DTM on the card against the same model on the
    CPU from one init: 1e-8 relative on the bound per iteration and on
    the globals (DTM at cgtol = 0)."""
    from topicmodelsvb_jl_torch import convert

    corp = _stamped_corpus()
    rt = tt.RuntimeConfig(chunk_docs=128, dtype="float64")
    kw = dict(delta=1.0) if fam == "DTM" else {}
    make = lambda d: getattr(tt, fam)(corp, 4, runtime=rt, device=d, seed=1, **kw)
    to_np, from_np = (getattr(convert, f"{fam.lower()}_state_to_numpy"),
                      getattr(convert, f"{fam.lower()}_state_from_numpy"))
    gpu = make(cuda)
    cpu = make("cpu")
    cpu.state = from_np(to_np(gpu.state), "cpu", torch.float64)
    train = dict(cgiter=5, cgtol=0.0) if fam == "DTM" else {}
    d0 = scatter_rows.launches_double
    gpu.train(iter=3, checkelbo=1, printelbo=False, **train)
    cpu.train(iter=3, checkelbo=1, printelbo=False, **train)
    assert scatter_rows.launches_double > d0
    ge = [x.elbo for x in gpu.trainer.trace]
    ce = [x.elbo for x in cpu.trainer.trace]
    assert len(ge) == len(ce) == 3
    assert max(abs(a - b) / abs(b) for a, b in zip(ge, ce)) <= 1e-8, (ge, ce)
    fields = ("alpha", "beta") if fam == "LDA" else ("alpha", "betahat", "mbeta")
    for f in fields:
        a, b = getattr(gpu.state, f).cpu(), getattr(cpu.state, f)
        torch.testing.assert_close(a, b, rtol=1e-8, atol=1e-12, msg=f)


# ── the float64 modes of ctpf_estep, the three pass modes, hmtm_estep and
# hmtm_logz, and the HMTM wide mode ──

# CiteULike's widest chunk (rows resident), K % 4 != 0, rows in tiles, and
# more topics than threads
CTPF64_SHAPES = [(1024, 80, 24, 100), (64, 40, 8, 101), (16, 600, 64, 100), (16, 40, 8, 257)]


@pytest.mark.parametrize("B,L,R,K", CTPF64_SHAPES)
def test_ctpf_estep_double_matches_plain(cuda, B, L, R, K):
    args = _f64(_ctpf_chunk(K, B, L, R, 8000, 5551, cuda, seed=K + L))
    kw = dict(viter=10, vtol=1.0 / K**2, **HYP)
    n0, d0 = ctpf_estep.launches, ctpf_estep.launches_double
    got = ctpf_estep(*args, **kw)
    torch.cuda.synchronize()
    assert (ctpf_estep.launches, ctpf_estep.launches_double) == (n0 + 1, d0 + 1)
    _close64(got, ctpf_estep_ref(*args, **kw), CTPF_NAMES)
    assert torch.all(got[4][-3:] == 0) and torch.all(got[5][-3:] == 0)
    for a, b in zip(got[:4], args[10:]):
        assert torch.equal(a[-3:], b[-3:])   # masked documents frozen
    assert all(torch.equal(a, b) for a, b in zip(got, ctpf_estep(*args, **kw)))


def _ctpf_res_edge(K):
    """The widest L + R whose rows the float64 resident design keeps in
    one block's shared memory at K topics (``double_shape``)."""
    lo, hi = 1, 4096
    assert ctpf_estep_mod.double_shape(1, 0, K)["design"] == "resident"
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if ctpf_estep_mod.double_shape(mid, 0, K)["design"] == "resident" \
            else (lo, mid)
    return lo


# ctpf_estep's float64 mode: CiteULike's widest chunk (resident at 2 blocks
# an SM), K = 101 (odd: 8-byte copies and stores), 64 and 65 (each side of
# 8 and 16 lanes a slot), 512 (32 lanes, the design's widest K) and 513
# (past it: the block kernel); at each K an
# L + R that just fits shared memory and one that just misses it; each at
# viter 10 and 0, with masked documents (one with slots, its rows from its
# state), a real one with no kept slot, one without readers and one whose
# slots are all kept; and at viter 10 with a stop test that ends every
# document's loop after one pass
CTPF64_CASES = [(1024, 80, 24, 100), (64, 40, 8, 101), (32, 40, 8, 64), (32, 40, 8, 65),
                (16, 24, 4, 512), (16, 24, 4, 513),
                (16, "edge", 8, 100), (16, "past", 8, 100), (8, "edge", 8, 512),
                (8, "past", 8, 512)]


@pytest.mark.parametrize("viter,vtol", [(10, None), (0, None), (10, 1e6)])
@pytest.mark.parametrize("B,L,R,K", CTPF64_CASES)
def test_ctpf_estep_double_designs_match_plain(cuda, B, L, R, K, viter, vtol):
    if L in ("edge", "past"):
        L = _ctpf_res_edge(K) - R + (L == "past")
    shape = ctpf_estep_mod.double_shape(L, R, K)
    fits = K <= 512 and L + R <= _ctpf_res_edge(K)
    assert (shape["design"] == "resident") == fits, shape
    assert shape["blocks"] >= 1, shape
    if (L, R, K) == (80, 24, 100):   # 16 lanes of 7 topics, two documents an SM
        assert shape == {**shape, "lanes": 16, "blocks": 2}, shape
    args = list(_f64(_ctpf_chunk(K, B, L, R, 8000, 5551, cuda, seed=K + L + viter)))
    args[3][1], args[5][1] = 0.0, 0.0                  # a real document with no kept slot
    args[5][2] = 0.0                                   # one without readers
    args[3][4] = torch.where(args[3][4] > 0, args[3][4], torch.ones_like(args[3][4]))
    args[5][4] = 1.0                                   # one whose slots are all kept
    args[6][0] = 0.0                                   # masked, with slots
    # vtol 1e6: every document stops after its first pass, before viter
    kw = dict(viter=viter, vtol=vtol or 1.0 / K**2, **HYP)
    n0, d0 = ctpf_estep.launches, ctpf_estep.launches_double
    got = ctpf_estep(*args, **kw)
    torch.cuda.synchronize()
    assert (ctpf_estep.launches, ctpf_estep.launches_double) == (n0 + 1, d0 + 1)
    _close64(got, ctpf_estep_ref(*args, **kw), CTPF_NAMES)
    assert torch.all(got[4][-3:] == 0) and torch.all(got[5][-3:] == 0)
    assert torch.all(got[4][1] == 0) and torch.all(got[5][1:3] == 0)
    assert torch.any(got[4][0] != 0)                   # masked: rows from its state
    for a, b in zip(got[:4], args[10:]):
        assert torch.equal(a[-3:], b[-3:]) and torch.equal(a[0], b[0])   # masked: frozen
        if viter == 0:
            assert torch.equal(a, b)                   # no pass: the state as given
    if viter:
        assert not torch.equal(got[0][1], args[10][1])   # no kept slot: gimel still moves
    assert all(torch.equal(a, b) for a, b in zip(got, ctpf_estep(*args, **kw)))


# K % 4 != 0 and wider than the block; L in shared memory and, at 1024
# (and L + R = 1153 for CTPF), in tiles; for the LDA and fLDA pass modes
# also one warp a document (L = 24), one long document among short ones,
# and K past the warp mode's reach (600: the block mode; CTPF's pass mode
# is not taken there)
@pytest.mark.parametrize("K", [101, 257, 600])
@pytest.mark.parametrize("L", [129, 1024, 24])
def test_pass_modes_double_match_plain(cuda, K, L):
    (betaT, terms, counts, doc_mask, _, _, El, _), _ = _chunk(K, 40, L, 3000, cuda, seed=K + L)
    fargs = list(_flda_pass_args(_flda_chunk(K, 40, L, 3000, cuda, seed=K + L)))
    for mod in (lda_estep_mod, flda_estep_mod):
        _check_pass_shape(mod.pass_shape(L, K, torch.float64), L, K)
    cases = []
    for layout, t, c in _pass_layouts(terms, counts):
        cases.append((lda_estep_pass, lda_estep_pass_ref,
                      _f64((betaT, t, c, doc_mask, El)), ("pc",), layout))
    for layout, fargs[2], fargs[3] in _pass_layouts(fargs[2], fargs[3]):
        cases.append((flda_estep_pass, flda_estep_pass_ref, _f64(fargs), ("pc", "tau_new"),
                      layout))
    if K <= 257:
        cases.append((ctpf_estep_pass, ctpf_estep_pass_ref, _f64(_ctpf_pass_args(
            _ctpf_chunk(K, 40, L, L // 8 + 1, 3000, 500, cuda, seed=K + L))), ("gsum", "zsum"),
            "mixed"))
    for fn, ref, args, names, layout in cases:
        n0, d0 = fn.launches, fn.launches_double
        got = fn(*args)
        torch.cuda.synchronize()
        assert (fn.launches, fn.launches_double) == (n0 + 1, d0 + 1), (fn.__name__, layout)
        tup = lambda x: (x,) if torch.is_tensor(x) else tuple(x)
        got = tup(got)
        _close64(got, tup(ref(*args)), names)
        assert torch.all(got[0][-3:] == 0), (fn.__name__, layout)   # masked documents
        assert all(torch.equal(a, b) for a, b in zip(got, tup(fn(*args)))), (fn.__name__,
                                                                             layout)


# K: NSF's 25 (one warp, shuffled doubles), 100 (shared memory, several
# warps), 169 (the widest A in shared memory in float64), and the cluster
# mode's 170 (clusters of 2; hmtm_logz 2), 257 and 300 (4; 4), 400 (8; 8)
# and 600 (16; 16), at L = 1, 2 and odd lengths too; 640 (past the
# cluster's reach: the wide mode; hmtm_logz 16)
@pytest.mark.parametrize("K,L", [(25, 128), (100, 64), (169, 16), (170, 16), (257, 12),
                                 (170, 1), (300, 2), (300, 13), (400, 8), (600, 6), (640, 4)])
def test_hmtm_double_matches_plain(cuda, K, L):
    B = 4 if K > 450 else (16 if K > 100 else 64)
    args = _f64(_hmtm_chunk(K, B, L, 2000, cuda, seed=K + L))
    kw = dict(viter=3, vtol=1.0 / K**2)
    e0, d0 = hmtm_estep.launches, hmtm_estep.launches_double
    w0 = _hmtm_counts()
    got = hmtm_estep(*args, **kw)
    torch.cuda.synchronize()
    assert (hmtm_estep.launches, hmtm_estep.launches_double) == (e0 + 1, d0 + 1)
    if K >= 169:   # A in one block's shared memory, in a cluster's, or in scratch
        assert _hmtm_mode(L, K, "_f64") == {169: 2, 640: 3}.get(K, 4)
    _close64(got, hmtm_estep_ref(*args, **kw), ("tau", "gamma", "r"))
    assert torch.all(got[2][args[2] == 0] == 0)
    assert torch.equal(got[0][-3:], args[6][-3:]) and torch.equal(got[1][-3:], args[7][-3:])
    assert all(torch.equal(a, b) for a, b in zip(got, hmtm_estep(*args, **kw)))
    zargs = (*args[:3], got[0], got[1])
    z0 = hmtm_logz.launches_double
    z = hmtm_logz(*zargs)
    assert hmtm_logz.launches_double == z0 + 1
    assert _hmtm_counts() == _hmtm_counted(w0, L, K, torch.float64, 2, 1)
    assert torch.equal(z, hmtm_logz(*zargs))
    _close64((z,), (hmtm_logz_ref(*zargs),), ("logZ",))


@pytest.mark.parametrize("fam", ["CTPF", "HMTM"])
def test_double_ctpf_and_hmtm_on_the_card_follow_the_cpu(cuda, fam):
    """A float64 CTPF and HMTM on the card against the same model on the
    CPU from one init: 1e-8 relative on the bound per iteration and on
    the globals; their kernels' float64 modes launched."""
    from topicmodelsvb_jl_torch import convert
    from topicmodelsvb_jl_torch.ops.packing import unit_counts

    if fam == "CTPF":
        corp = tt.pack_corpus(tt.synth_corpus(M=1500, V=600, K=8, U=300, seed=3, mean_tokens=40,
                                              mean_terms=25, mean_readers=4), with_readers=True)
        fields, kernels = ("alef", "bet", "dalet", "he", "vav", "het"), (ctpf_estep,)
    else:
        corp = unit_counts(tt.synth_packed_nsf_scale(M=800, V=400, mean_terms=30, seed=2))
        fields, kernels = ("eta", "alpha", "beta"), (hmtm_estep, hmtm_logz)
    rt = tt.RuntimeConfig(chunk_docs=128, dtype="float64")
    gpu = getattr(tt, fam)(corp, 6, rt, device=cuda, seed=1)
    cpu = getattr(tt, fam)(corp, 6, rt, device="cpu", seed=1)
    to_np, from_np = (getattr(convert, f"{fam.lower()}_state_to_numpy"),
                      getattr(convert, f"{fam.lower()}_state_from_numpy"))
    cpu.state = from_np(to_np(gpu.state), "cpu", torch.float64)
    d0 = [k.launches_double for k in kernels]
    gpu.train(iter=3, checkelbo=1, printelbo=False)
    cpu.train(iter=3, checkelbo=1, printelbo=False)
    assert all(k.launches_double > d for k, d in zip(kernels, d0))
    ge = [x.elbo for x in gpu.trainer.trace]
    ce = [x.elbo for x in cpu.trainer.trace]
    assert len(ge) == len(ce) == 3
    assert max(abs(a - b) / abs(b) for a, b in zip(ge, ce)) <= 1e-8, (ge, ce)
    for f in fields:
        a, b = getattr(gpu.state, f).cpu(), getattr(cpu.state, f)
        assert a.dtype == torch.float64
        torch.testing.assert_close(a, b, rtol=1e-8, atol=1e-12, msg=f)


# ── the kernels' EPSILON: the port's, which the plain versions add ──

def _in(dtype, args):
    return tuple(a.to(dtype) if torch.is_floating_point(a) else a for a in args)


def _tol(dtype):
    return dict(rtol=RTOL64, atol=ATOL64) if dtype == torch.float64 else dict(rtol=5e-3, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_lda_estep_epsilon_decides_gamma(cuda, dtype):
    """A real document with no counts gets gamma = alpha + EPSILON; where
    alpha is 1e-30, EPSILON is most of gamma, so a kernel that added
    another value (1.6% larger moved gamma by ~1%) would miss the plain
    version there."""
    (betaT, terms, counts, doc_mask, alpha, *rest), _ = _chunk(100, 16, 64, 3000, cuda, seed=5)
    counts, alpha = counts.clone(), alpha.clone()
    counts[1] = 0.0
    alpha[:10] = 1e-30
    args = _in(dtype, (betaT, terms, counts, doc_mask, alpha, *rest))
    got = lda_estep(*args, viter=3, vtol=1e-4)
    want = lda_estep_ref(*args, viter=3, vtol=1e-4)
    for name, a, b in zip(("gamma", "El", "El_old", "w"), got, want):
        torch.testing.assert_close(a, b, **_tol(dtype), msg=name)
    assert torch.equal(got[0][1, :10], args[4][:10] + EPSILON)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_flda_estep_epsilon_decides_gamma(cuda, dtype):
    """fLDA's gamma = alpha + pc + EPSILON on a real document with no
    counts and alpha 1e-30: EPSILON decides it."""
    a = list(_flda_chunk(100, 16, 64, 3000, cuda, seed=6))
    a[3], a[5] = a[3].clone(), a[5].clone()
    a[3][1] = 0.0
    a[5][:10] = 1e-30
    args = _in(dtype, a)
    got = flda_estep(*args, viter=3, vtol=1e-4)
    want = flda_estep_ref(*args, viter=3, vtol=1e-4)
    for name, x, y in zip(("gamma", "El", "El_old", "tau", "tau_old", "w"), got, want):
        torch.testing.assert_close(x, y, **_tol(dtype), msg=name)
    assert torch.equal(got[0][1, :10], args[5][:10] + EPSILON)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_ctpf_estep_epsilon_decides_a_row(cuda, dtype):
    """A term whose rates are 1e-32 in every topic: the slot's normaliser
    sum ea·qp + EPSILON is mostly EPSILON, so its row wa = ea qp c / that
    sum, and the kernel's, follow the value of EPSILON."""
    a = list(_ctpf_chunk(100, 16, 40, 8, 3000, 500, cuda, seed=7))
    a[0], a[2], a[3] = a[0].clone(), a[2].clone(), a[3].clone()
    a[0][2999] = 1e-32
    a[2][0, 0], a[3][0, 0] = 2999, 1.0
    args = _in(dtype, a)
    kw = dict(viter=3, vtol=1e-4, **HYP)
    got = ctpf_estep(*args, **kw)
    want = ctpf_estep_ref(*args, **kw)
    for name, x, y in zip(CTPF_NAMES, got, want):
        torch.testing.assert_close(x, y, **_tol(dtype), msg=name)
    # the row sums to c S / (S + EPSILON), S = sum ea·qp: below c / 2, EPSILON
    # is most of the normaliser
    assert 0.0 < float(want[4][0, 0].sum()) < 0.5
