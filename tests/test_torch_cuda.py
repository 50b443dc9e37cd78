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
from topicmodelsvb_jl_torch.kernels.ctpf_estep import ctpf_estep, ctpf_estep_ref
from topicmodelsvb_jl_torch.kernels.flda_estep import flda_estep, flda_estep_ref
from topicmodelsvb_jl_torch.kernels.lda_elbo import lda_elbo_tok, lda_elbo_tok_ref
from topicmodelsvb_jl_torch.kernels.lda_estep import lda_estep, lda_estep_ref
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
    with pytest.raises(TypeError, match="betaT"):
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
