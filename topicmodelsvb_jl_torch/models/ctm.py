"""Correlated topic model — batch-synchronous CAVI on one device.

PyTorch port of the JAX package's ``models/ctm.py`` on its bucketed
single-device path (reference ``src/CTM.jl`` and its OpenCL twin
``src/gpuCTM.jl``):

* The per-document E-step (CTM.jl:190-201) runs chunk by chunk over the
  length-bucketed segments, each document frozen once it converges; per
  pass: phi, logzeta, vsq (CTM.jl:146-165), then lambda (CTM.jl:129-142),
  both through the batched Newtons of ``ops/newton.py``.  The JAX package
  has no kernel for it: it is plain PyTorch, as the JAX package's XLA body.
* The beta statistic goes through the deterministic scatter along one plan
  per chunk (``lda.token_plans``); phi of a zero-count slot is exactly 0.
* mu and sigma come from the first and second moments of lambda; sigma
  uses the *previous* mu (update_sigma! before update_mu!, CTM.jl:206-208).
* The bound's token terms go through ``kernels/lda_elbo`` with
  (Elogtheta, Elogtheta_old) := (lambda, lambda_old), as the JAX package's
  ``scan_body_pallas`` does.
* On the sequence axis each document's token slots are split over ranks:
  the Newtons' token inputs (C once a chunk, phi@counts every pass) are
  summed over the axis, between the Newtons, and the Newtons then run
  alike on every rank (the JAX package's models/ctm.py:85-116).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..kernels.lda_elbo import lda_elbo_tok
from ..ops.newton import ctm_lambda_newton, ctm_vsq_newton
from ..ops.segment import count_scatter_into
from ..parallel.shard import all_gather, psum, tp_normalize_rows
from ..utils.numerics import (
    EPSILON, dirichlet_ones, kbn_add, kbn_merge, kbn_pack, kbn_psum, kbn_zero, l2norm,
    logsumexp,
    masked_fixpoint, mvnormal_diag_entropy,
)
from .lda import _chunks, as_segments, check_modes, token_axes, token_plans, token_reduce


@dataclasses.dataclass
class CTMState:
    mu: torch.Tensor          # [K]
    sigma: torch.Tensor       # [K, K]
    invsigma: torch.Tensor    # [K, K]
    beta: torch.Tensor        # [K, V] right-stochastic rows
    beta_old: torch.Tensor    # [K, V]
    lam: torch.Tensor         # [M_pad, K] (lambda)
    lam_old: torch.Tensor     # [M_pad, K]
    vsq: torch.Tensor         # [M_pad, K]
    logzeta: torch.Tensor     # [M_pad]
    elbo: torch.Tensor        # compensated (hi, lo) bound, shape (2,)


def init(generator: torch.Generator, packed, K: int, dtype=torch.float32,
         device="cpu") -> CTMState:
    """Constructor state (reference CTM.jl:27-52).  beta is drawn on
    ``generator``'s device and then moved to ``device``."""
    M_pad, V = packed.M_pad, packed.V
    beta = dirichlet_ones(generator, V, (K,), dtype).to(device)
    eye = torch.eye(K, dtype=dtype, device=device)
    zeros = torch.zeros((M_pad, K), dtype=dtype, device=device)
    return CTMState(
        mu=torch.zeros((K,), dtype=dtype, device=device), sigma=eye, invsigma=eye,
        beta=beta, beta_old=beta, lam=zeros, lam_old=zeros,
        vsq=torch.ones((M_pad, K), dtype=dtype, device=device),
        logzeta=torch.full((M_pad,), 0.5, dtype=dtype, device=device),
        elbo=torch.zeros((2,), dtype=dtype, device=device),
    )


def beta_rows(bt: torch.Tensor, row_sum=None) -> torch.Tensor:
    """Normalise the [K, V] statistic's rows (by ``row_sum`` [K, 1] when
    given: a vocab block's rows by the whole rows' sums); a dead topic
    (no mass, only in degenerate regimes) becomes the uniform row instead
    of 0/0, which would poison every topic's phi through log(beta) on the
    next sweep."""
    if row_sum is None:
        row_sum = torch.sum(bt, dim=1, keepdim=True)
    return torch.where(row_sum > 0, bt / row_sum, 1.0 / bt.shape[1])


def gaussian_update(state, vsq_sum, lam_sum, lam_outer, M_total, identify: bool):
    """(mu, sigma, invsigma) from the moments of lambda (CTM.jl:102-111).

    sigma uses the previous mu (CTM.jl:206-208); ``identify=True`` pins the
    logistic normal's unidentified 1-direction each step (μ ← Pμ,
    σ ← PσP + 11ᵀ/K, P = I − 11ᵀ/K), the projection the reference's
    todo.txt:25 proposes (see the JAX package's ``models/ctm.py``)."""
    K = lam_sum.shape[0]
    mu_old = state.mu
    centered = (lam_outer - torch.outer(mu_old, lam_sum) - torch.outer(lam_sum, mu_old)
                + M_total * torch.outer(mu_old, mu_old))
    sigma = (torch.diag(vsq_sum) + centered) / M_total
    sigma = 0.5 * (sigma + sigma.T)
    mu = lam_sum / M_total
    if identify:
        ones_K = torch.full((K, K), 1.0 / K, dtype=sigma.dtype, device=sigma.device)
        P = torch.eye(K, dtype=sigma.dtype, device=sigma.device) - ones_K
        sigma = P @ sigma @ P + ones_K
        sigma = 0.5 * (sigma + sigma.T)
        mu = mu - torch.mean(mu)
    invsigma = torch.linalg.inv(sigma)
    return mu, sigma, 0.5 * (invsigma + invsigma.T)


def estep_chunk(logbetaT, mu, invsigma, terms, counts, doc_mask, lam, lam_old, vsq,
                logzeta, viter, vtol, niter, ntol, tok_reduce=None):
    """One chunk's E-step; returns its new per-document state and the rows
    ``w = phi·counts`` [B, L, K] of the beta statistic.  ``tok_reduce``
    (the sequence axis) sums the per-document token sums over the ranks
    holding the documents' other slots: C once, phi@counts every pass,
    each before the Newtons read it."""
    C = torch.sum(counts, dim=-1)
    if tok_reduce is not None:
        C = tok_reduce(C)
    # a zero-count slot may gather a zero beta column whose raw log is
    # -inf for every k; every use of phi is count-weighted, so
    # neutralising those logits is exact and keeps the softmax finite
    logbeta_d = torch.where(counts[..., None] > 0, logbetaT[terms], 0.0)   # [B, L, K]
    isd = torch.diagonal(invsigma)

    def body(_, carry):
        lam, lam_old, vsq, logzeta, active = carry
        p = torch.softmax(logbeta_d + lam[:, None, :], dim=-1)       # CTM.jl:175-178
        logzeta2 = torch.where(active, logsumexp(lam + 0.5 * vsq), logzeta)
        vsq2 = ctm_vsq_newton(lam, vsq, logzeta2, C, isd, active, niter, ntol)
        vsq2 = torch.where(active[:, None], vsq2, vsq)
        pc = torch.einsum("bl,blk->bk", counts, p)
        if tok_reduce is not None:
            pc = tok_reduce(pc)
        lam_new = ctm_lambda_newton(lam, vsq2, logzeta2, pc, C, mu, invsigma, active,
                                    niter, ntol)
        upd = active[:, None]
        lam_old2 = torch.where(upd, lam, lam_old)
        lam2 = torch.where(upd, lam_new, lam)
        # break: ‖lambda − lambda_old‖ < vtol (CTM.jl:200)
        return lam2, lam_old2, vsq2, logzeta2, active & (l2norm(lam2 - lam_old2) >= vtol)

    lam, lam_old, vsq, logzeta, _ = masked_fixpoint(
        body, (lam, lam_old, vsq, logzeta, doc_mask > 0), viter)
    # M-step statistic with the last phi = f(beta, lambda_old) (CTM.jl:93, 122-125)
    w = torch.softmax(logbeta_d + lam_old[:, None, :], dim=-1) * counts[..., None]
    return lam, lam_old, vsq, logzeta, w


def moment_sums(lam, vsq, doc_mask) -> tuple:
    """A chunk's lambda sum [K], vsq sum [K] and Σ lambda·lambdaᵀ [K, K]
    over real documents: the statistics of mu and sigma."""
    return (torch.sum(lam * doc_mask[:, None], dim=0), torch.sum(vsq * doc_mask[:, None], dim=0),
            (lam * doc_mask[:, None]).T @ lam)


def sweep_chunk(logbetaT, mu, invsigma, terms, counts, doc_mask, lam, lam_old, vsq, logzeta,
                plan, beta_temp, viter, vtol, niter, ntol, tok_reduce=None) -> tuple:
    """One chunk of the E-step sweep, on any [B, L] chunk: the fixpoint of
    :func:`estep_chunk` (``tok_reduce``: the sequence axis), its rows
    added into ``beta_temp`` [V, K] along ``plan``, in place.  Returns
    the chunk's new (lam, lam_old, vsq, logzeta) and its
    :func:`moment_sums`."""
    la, lao, v, lz, w = estep_chunk(logbetaT, mu, invsigma, terms, counts, doc_mask, lam,
                                    lam_old, vsq, logzeta, viter, vtol, niter, ntol,
                                    tok_reduce)
    count_scatter_into(beta_temp, w.reshape(-1, w.shape[-1]), plan)
    return (la, lao, v, lz, *moment_sums(la, v, doc_mask))


def global_update(g, beta_temp, vsq_sum, lam_sum, lam_outer, M_total, identify: bool) -> tuple:
    """(mu, sigma, invsigma, beta) from a sweep's statistics; ``g`` holds
    the previous mu (CTM.jl:102-118, order CTM.jl:206-208)."""
    beta_new = beta_rows(beta_temp.T.contiguous())     # CTM.jl:114-118
    mu, sigma, invsigma = gaussian_update(g, vsq_sum, lam_sum, lam_outer, M_total, identify)
    return mu, sigma, invsigma, beta_new


def make_step(packed, K: int, viter: int, vtol: float, niter: int, ntol: float,
              chunk_docs: int, device, identify: bool = False, mesh=None, axis_name=None,
              vocab_axis=None, seq_axis=None):
    """Build the outer-iteration step (one full CAVI sweep).

    ``step(state, terms, counts, doc_mask, M_total)`` takes the per-
    segment tuples of device tensors (one tensor each for a dense corpus)
    on ``device`` and returns the next state; the chunks' scatter plans are
    built here and put on ``device``.  With a ``mesh`` (``packed`` this
    process's slab), the moments (vsq_sum, lam_sum, lam_outer) and the
    beta statistic are summed over ``axis_name`` before the M-step.
    ``vocab_axis`` shards beta's storage (``[K, V/n]`` blocks), gathered
    whole for the E-step; the new block comes from ``tp_normalize_rows``.
    ``seq_axis`` splits every document's token slots (``packed`` the slab
    of this process's rows and token columns, dense): the Newtons' token
    inputs are summed over it (:func:`estep_chunk`), and so is the beta
    statistic, while the moments sum over ``axis_name`` alone (the JAX
    package's models/ctm.py:232-251).
    """
    check_modes(vocab_axis, seq_axis, False, packed)
    V = packed.V
    chunks = _chunks(packed, chunk_docs)
    plans = token_plans(packed, chunk_docs, device)
    tok_reduce = token_reduce(mesh, seq_axis)
    tok_axes = token_axes(axis_name, seq_axis)

    def step(state: CTMState, terms, counts, doc_mask, M_total) -> CTMState:
        terms, counts, doc_mask = (as_segments(x) for x in (terms, counts, doc_mask))
        dt, dev = state.beta.dtype, state.beta.device
        beta = state.beta
        if vocab_axis is not None:
            beta = all_gather(beta, mesh, vocab_axis, dim=1)
        logbetaT = torch.log(beta).T.contiguous()         # raw log (CTM.jl:177)
        beta_temp = torch.zeros((V, K), dtype=dt, device=dev)
        vsq_sum = torch.zeros((K,), dtype=dt, device=dev)
        lam_sum = torch.zeros((K,), dtype=dt, device=dev)
        lam_outer = torch.zeros((K, K), dtype=dt, device=dev)
        new = {f: torch.empty_like(getattr(state, f))
               for f in ("lam", "lam_old", "vsq", "logzeta")}
        for (rows, j, sl), plan in zip(chunks, plans):
            *out, ls, vs, lo = sweep_chunk(
                logbetaT, state.mu, state.invsigma, terms[j][sl], counts[j][sl],
                doc_mask[j][sl], state.lam[rows], state.lam_old[rows], state.vsq[rows],
                state.logzeta[rows], plan, beta_temp, viter, vtol, niter, ntol, tok_reduce)
            lam_sum = lam_sum + ls
            vsq_sum = vsq_sum + vs
            lam_outer = lam_outer + lo
            for f, x in zip(new, out):
                new[f][rows] = x

        vsq_sum, lam_sum, lam_outer = (
            psum(x, mesh, axis_name) for x in (vsq_sum, lam_sum, lam_outer))
        if vocab_axis is not None:
            local, row_sum = tp_normalize_rows(beta_temp, mesh, vocab_axis, tok_axes)
            beta_new = beta_rows(local.T.contiguous(), row_sum[:, None])
            mu, sigma, invsigma = gaussian_update(state, vsq_sum, lam_sum, lam_outer,
                                                  M_total, identify)
        else:
            mu, sigma, invsigma, beta_new = global_update(
                state, psum(beta_temp, mesh, tok_axes), vsq_sum, lam_sum, lam_outer,
                M_total, identify)
        return CTMState(mu=mu, sigma=sigma, invsigma=invsigma, beta=beta_new,
                        beta_old=state.beta, elbo=state.elbo, **new)

    return step


def gaussian_terms(state, la, v, lz, cd, K: int, logdet_inv):
    """Elogpeta − Elogqeta and the logzeta bound's −C·(...) part of Elogpz,
    per document (CTM.jl:56-66, 76-79)."""
    diff = la - state.mu
    quad = torch.sum((diff @ state.invsigma) * diff, dim=-1)
    isd = torch.diagonal(state.invsigma)
    e_peta = 0.5 * (logdet_inv - K * math.log(2.0 * math.pi) - torch.sum(isd * v, -1) - quad)
    bound = torch.sum(torch.exp(la + 0.5 * v - lz[:, None]), -1) + lz - 1.0
    return e_peta - cd * bound + mvnormal_diag_entropy(v)


def logdet_invsigma(state) -> torch.Tensor:
    """log det Σ⁻¹ through its Cholesky factor (Σ⁻¹ is SPD)."""
    return 2.0 * torch.sum(torch.log(torch.diagonal(torch.linalg.cholesky(state.invsigma))))


def elbo_tables(state, beta=None, beta_old=None):
    """``lda_elbo_tok``'s tables for the CTM bound: the raw beta_old
    (CTM.jl:93) and ``g2 = bo·(log(beta + EPSILON) − log bo)``, 0 where
    bo = 0, both [V, K]; ``beta``/``beta_old`` replace the state's (the
    gathered whole under a vocab axis)."""
    beta = state.beta if beta is None else beta
    beta_old = state.beta_old if beta_old is None else beta_old
    boT = beta_old.T.contiguous()
    logbetaT = torch.log(beta + EPSILON).T                     # CTM.jl:71
    g2T = torch.where(boT > 0, boT * (logbetaT - torch.log(boT)), 0.0).contiguous()
    return boT, g2T


def make_elbo(packed, K: int, chunk_docs: int, mesh=None, axis_name=None, vocab_axis=None,
              seq_axis=None):
    """ELBO (CTM.jl:55-98): phi recomputed from (beta_old, lambda_old), the
    terms with the current parameters.  The token terms Elogpz (its
    Σ φc·λ part) + Elogpw − Elogqz are ``lda_elbo_tok`` on the tables of
    :func:`elbo_tables`; the doc terms are [B, K] tensor ops.
    ``vocab_axis`` gathers beta and beta_old whole first.  With
    ``seq_axis`` the per-document token count is summed over it before the
    document terms use it; the token terms, linear in each slot, sum over
    it with the data axes, and the document terms over the data axes alone
    (the JAX package's models/ctm.py:361-363, 412-418).
    """
    check_modes(vocab_axis, seq_axis, False, packed)
    chunks = _chunks(packed, chunk_docs)
    tok_reduce = token_reduce(mesh, seq_axis)

    def elbo(state: CTMState, terms, counts, doc_mask) -> torch.Tensor:
        terms, counts, doc_mask = (as_segments(x) for x in (terms, counts, doc_mask))
        dt, dev = state.beta.dtype, state.beta.device
        full = ()
        if vocab_axis is not None:
            full = tuple(all_gather(x, mesh, vocab_axis, dim=1)
                         for x in (state.beta, state.beta_old))
        tables = (*elbo_tables(state, *full), logdet_invsigma(state), state)
        acc_doc, acc_tok = kbn_zero(dt, dev), kbn_zero(dt, dev)
        for rows, j, sl in chunks:
            doc, tok = elbo_chunk(tables, terms[j][sl], counts[j][sl], doc_mask[j][sl],
                                  state.lam[rows], state.lam_old[rows], state.vsq[rows],
                                  state.logzeta[rows], tok_reduce)
            acc_doc = kbn_add(acc_doc, doc)
            acc_tok = kbn_add(acc_tok, tok)
        # the document terms are alike on every rank of the sequence
        # axis: the token pair is summed over it first, then the merged pair
        return kbn_pack(kbn_psum(kbn_merge(acc_doc, kbn_psum(acc_tok, mesh, seq_axis)),
                                 mesh, axis_name))

    return elbo


def elbo_chunk(tables, t, c, dm, la, lao, v, lz, tok_reduce=None) -> tuple:
    """One chunk's bound, on any [B, L] chunk: (doc terms, token terms),
    each summed over its real documents.  ``tables`` is
    (boT, g2T, log det Σ⁻¹, the globals); ``tok_reduce`` (the sequence
    axis) sums the per-document token count over the ranks first."""
    boT, g2T, logdet_inv, g = tables
    tok = lda_elbo_tok(boT, g2T, t, c, dm, la, lao)
    cd = torch.sum(c, dim=-1)
    if tok_reduce is not None:
        cd = tok_reduce(cd)
    doc = gaussian_terms(g, la, v, lz, cd, la.shape[1], logdet_inv)
    return torch.sum(dm * doc), tok


def topicdist(lam: torch.Tensor, vsq: torch.Tensor) -> torch.Tensor:
    """softmax(lambda + vsq/2): E[exp x_i]/Σ E[exp x_j] under the mean-field
    Gaussian, the reference's moment approximation (modelutils.jl:953-958)."""
    return torch.softmax(lam + 0.5 * vsq, dim=-1)
