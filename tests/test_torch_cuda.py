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
from topicmodelsvb_jl_torch.kernels.lda_elbo import lda_elbo_tok, lda_elbo_tok_ref
from topicmodelsvb_jl_torch.kernels.lda_estep import lda_estep, lda_estep_ref
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


# (100, 136): the widest NSF bucket, rows in shared memory;
# (100, 700): rows beyond the shared-memory limit, read from the table;
# (160, 40): more topics than threads in a block
@pytest.mark.parametrize("K,L", [(7, 24), (100, 136), (100, 700), (160, 40)])
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
    g = torch.Generator(device=cuda).manual_seed(0)
    ids = torch.randint(0, 500, (200_000,), generator=g, device=cuda, dtype=torch.int32)
    w = torch.rand((200_000, 100), generator=g, device=cuda)
    a = count_scatter_into(torch.zeros(500, 100, device=cuda), w, ids)
    b = count_scatter_into(torch.zeros(500, 100, device=cuda), w, ids)
    assert torch.equal(a, b)
    ref = torch.zeros(500, 100, dtype=torch.float64).index_add_(
        0, ids.cpu().long(), w.cpu().double())
    torch.testing.assert_close(a.cpu().double(), ref, rtol=1e-5, atol=1e-3)


def test_lda_trains_through_the_kernels(cuda):
    p = tt.synth_packed_nsf_scale(M=3000, V=800, mean_terms=40, seed=2)
    m = tt.LDA(p, 16, tt.RuntimeConfig(chunk_docs=256), device=cuda, seed=1)
    e0, k0 = lda_estep.launches, lda_elbo_tok.launches
    m.train(iter=3, checkelbo=1, printelbo=False)
    n_chunks = sum(s.terms.shape[0] for s in m.packed.segments) // m.chunk_docs
    assert lda_estep.launches - e0 == 3 * n_chunks
    assert lda_elbo_tok.launches - k0 == 4 * n_chunks
    assert all(r.delta_elbo > 0 for r in m.trainer.trace)
