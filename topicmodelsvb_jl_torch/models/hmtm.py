"""Hidden Markov topic model — structured VB, batch-synchronous CAVI on one
device.

PyTorch port of the JAX package's ``models/hmtm.py`` on its single-device
path: the completion of the reference's unfinished ``HMTM/HMTM.jl`` stub,
whose variational family for the topic chain is replaced by the exact
chain posterior under expected-log parameters (Beal 2003, ch. 3).

* ``pi_d ~ Dir(eta)``, ``theta_d[:, l] ~ Dir(alpha[:, l])``, ``z_1 ~
  Cat(pi_d)``, ``z_n | z_{n-1} = l ~ Cat(theta_d[:, l])``, ``w_n | z_n = i
  ~ Cat(beta[i, :])``; ``q(pi_d) = Dir(tau_d)``, ``q(theta_d[:, l]) =
  Dir(gamma_d[:, l])``.
* The E-step is ``hmtm_estep`` a chunk (the chain fixpoint by scaled
  forward-backward, each document frozen once ‖Δgamma‖_F < vtol), and
  ``beta_temp[:, w_n] += q(z_n)`` goes through ``count_scatter_into`` along
  one plan per chunk, built once per trainer.
* eta and each column of alpha get the reference's interior-point
  Dirichlet Newton, all K + 1 of them in one batched call.
* ELBO = Σ_d log Z̃_d + E[log p(pi)/q(pi)] + E[log p(theta)/q(theta)],
  with ``log Z̃_d`` from ``hmtm_logz``.

Every entry of a document's terms vector is one token in order and counts
only mark padding, so HMTM wants un-condensed corpora (``expand_corp``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..kernels._build import check_dtype
from ..kernels.hmtm_estep import hmtm_estep, hmtm_logz
from ..ops.newton import dirichlet_newton_batched
from ..ops.segment import count_scatter_into
from ..parallel.mesh import axis_tuple
from ..parallel.shard import all_gather, psum, psum_scatter
from ..utils.numerics import (
    EPSILON, digamma, dirichlet_entropy, dirichlet_ones, kbn_add, kbn_pack, kbn_psum,
    kbn_zero, kbn_zeros, lgamma,
)
from .lda import _chunks, as_segments, token_plans


@dataclasses.dataclass
class HMTMState:
    eta: torch.Tensor     # [K] Dirichlet prior on pi
    alpha: torch.Tensor   # [K, K] column l = Dirichlet prior on theta[:, l]
    beta: torch.Tensor    # [K, V] right-stochastic rows
    tau: torch.Tensor     # [M_pad, K] q(pi_d)
    gamma: torch.Tensor   # [M_pad, K, K] q(theta_d), columns are Dirichlets
    elbo: torch.Tensor    # compensated (hi, lo) bound, shape (2,)


def check_order_preserving(packed) -> None:
    """HMTM reads terms as an ordered token stream and ignores counts
    (HMTM.jl:63-67): a condensed corpus (a term count > 1) would be fit
    with its multiplicity and its word order lost, so it is refused."""
    if getattr(packed, "max_count", 0) > 1:
        raise ValueError(
            "HMTM requires an order-preserving corpus (one entry per "
            "token, all counts == 1); this corpus has term counts > 1 — "
            "it was condensed (condense_corp / fixcorp). Re-read the "
            "corpus without condensing to train an HMTM.")


def init(generator: torch.Generator, packed, K: int, dtype=torch.float32,
         device="cpu") -> HMTMState:
    """Constructor state (reference HMTM.jl:26-32).  beta is drawn on
    ``generator``'s device and then moved to ``device``."""
    check_order_preserving(packed)
    M_pad, V = packed.M_pad, packed.V
    ones = lambda *shape: torch.ones(shape, dtype=dtype, device=device)
    return HMTMState(
        eta=ones(K), alpha=ones(K, K),
        beta=dirichlet_ones(generator, V, (K,), dtype).to(device),
        tau=ones(M_pad, K), gamma=ones(M_pad, K, K),
        elbo=torch.zeros((2,), dtype=dtype, device=device),
    )


def _elog(tau, gamma):
    """E[log pi] [B, K] and E[log theta] [B, K, K] (columns Dirichlet)."""
    return (digamma(tau) - digamma(torch.sum(tau, -1, keepdim=True)),
            digamma(gamma) - digamma(torch.sum(gamma, -2, keepdim=True)))


def sweep_chunk(betaT_eps, eta, alpha, terms, counts, doc_mask, tau, gamma, plan, beta_temp,
                viter: int, vtol: float) -> tuple:
    """One chunk of the E-step sweep, on any [B, L] chunk: the chain
    fixpoint through ``hmtm_estep``, then updateBeta!'s rows r = q(z_n)
    (HMTM.jl:149-158; exactly 0 on padding) added into ``beta_temp``
    [V, K] along ``plan``, in place.  Returns the chunk's new (tau, gamma)
    and its E[log pi] [K] and E[log theta] [K, K] sums over real
    documents."""
    tau2, gamma2, r = hmtm_estep(betaT_eps, terms, (counts > 0).to(betaT_eps.dtype), doc_mask,
                                 eta, alpha, tau, gamma, viter=viter, vtol=vtol)
    count_scatter_into(beta_temp, r.reshape(-1, r.shape[-1]), plan)
    Elogpi, Elogth = _elog(tau2, gamma2)
    return (tau2, gamma2, torch.sum(Elogpi * doc_mask[:, None], dim=0),
            torch.sum(Elogth * doc_mask[:, None, None], dim=0))


def global_update(eta, alpha, beta_temp, pi_sum, th_sum, M_total: float, niter: int,
                  ntol: float, row_sum=None) -> tuple:
    """(eta, alpha, beta) from a sweep's statistics; ``pi_sum`` and
    ``th_sum`` are (hi, lo) pairs; ``row_sum`` [K], when given, divides
    the rows (a vocab block's rows by the whole rows' sums)."""
    K = eta.shape[0]
    bt = beta_temp.T
    if row_sum is None:
        row_sum = torch.sum(bt, dim=1)
    beta_new = (bt / row_sum[:, None]).contiguous()
    # updateEta!/updateAlpha! (HMTM.jl:103-147): eta and alpha's K
    # columns are independent Dirichlet Newtons, each row of one
    # batched call running the iterations it would run alone
    el = torch.cat([pi_sum[0][None], th_sum[0].T])
    el_lo = torch.cat([pi_sum[1][None], th_sum[1].T])
    M = torch.full((K + 1,), float(M_total), dtype=eta.dtype, device=eta.device)
    new = dirichlet_newton_batched(torch.cat([eta[None], alpha.T]), el, M, niter, ntol, el_lo)
    return new[0], new[1:].T.contiguous(), beta_new


def make_step(packed, K: int, viter: int, vtol: float, niter: int, ntol: float,
              chunk_docs: int, device, mesh=None, axis_name=None, vocab_axis=None):
    """Build the outer-iteration step (one full CAVI sweep, reference
    train!, HMTM.jl:189-215).

    ``step(state, terms, counts, doc_mask, M_total)`` takes the per-
    segment tuples of device tensors and returns the next state; it is
    ``step.sweep`` (the E-step over the chunks, with the M-step
    statistics) then ``step.update`` (beta and the Newtons).  With a
    ``mesh`` (``packed`` this process's slab), the sweep ends by summing
    pi_sum, th_sum and beta_temp over ``axis_name``.  ``vocab_axis``
    shards beta's storage (``[K, V/n]`` blocks): the sweep gathers it
    whole for the kernels and keeps its own block of beta_temp, whose
    rows the update divides by the whole rows' sums."""
    V = packed.V
    chunks = _chunks(packed, chunk_docs)
    plans = token_plans(packed, chunk_docs, device)

    def sweep(state: HMTMState, terms, counts, doc_mask):
        """(tau, gamma, beta_temp [V, K], pi_sum, th_sum): the new
        per-document state and the statistics, the sums as (hi, lo)."""
        terms, counts, doc_mask = (as_segments(x) for x in (terms, counts, doc_mask))
        dtype, dev = state.beta.dtype, state.beta.device
        beta = state.beta
        if vocab_axis is not None:
            beta = all_gather(beta, mesh, vocab_axis, dim=1)
        betaT_eps = (beta.T + EPSILON).contiguous()              # [V, K]
        beta_temp = torch.zeros((V, K), dtype=dtype, device=dev)
        # the pi and theta statistic sums ride compensated (hi, lo)
        # carries into both Newtons, as LDA's Elogtheta sum does
        pi_sum, th_sum = kbn_zeros((K,), dtype, dev), kbn_zeros((K, K), dtype, dev)
        tau, gamma = torch.empty_like(state.tau), torch.empty_like(state.gamma)
        for (rows, j, sl), plan in zip(chunks, plans):
            tau2, gamma2, pi_part, th_part = sweep_chunk(
                betaT_eps, state.eta, state.alpha, terms[j][sl], counts[j][sl],
                doc_mask[j][sl], state.tau[rows], state.gamma[rows], plan, beta_temp,
                viter, vtol)
            pi_sum = kbn_add(pi_sum, pi_part)
            th_sum = kbn_add(th_sum, th_part)
            tau[rows], gamma[rows] = tau2, gamma2
        pi_sum = kbn_psum(pi_sum, mesh, axis_name)
        th_sum = kbn_psum(th_sum, mesh, axis_name)
        if vocab_axis is not None:
            beta_temp = psum(psum_scatter(beta_temp, mesh, vocab_axis),
                             mesh, tuple(a for a in axis_tuple(axis_name) if a != vocab_axis))
        else:
            beta_temp = psum(beta_temp, mesh, axis_name)
        return tau, gamma, beta_temp, pi_sum, th_sum

    def update(eta, alpha, beta_temp, pi_sum, th_sum, M_total: float):
        """(eta, alpha, beta) from the sweep's statistics."""
        row_sum = None
        if vocab_axis is not None:
            row_sum = psum(torch.sum(beta_temp, dim=0), mesh, vocab_axis)
        return global_update(eta, alpha, beta_temp, pi_sum, th_sum, M_total, niter, ntol,
                             row_sum)

    def step(state: HMTMState, terms, counts, doc_mask, M_total) -> HMTMState:
        check_dtype("HMTM", state.beta.dtype, state.beta.device)
        tau, gamma, *stats = sweep(state, terms, counts, doc_mask)
        eta, alpha, beta = update(state.eta, state.alpha, *stats, M_total)
        return HMTMState(eta=eta, alpha=alpha, beta=beta, tau=tau, gamma=gamma,
                         elbo=state.elbo)

    step.sweep, step.update = sweep, update
    return step


def make_elbo(packed, K: int, chunk_docs: int, mesh=None, axis_name=None, vocab_axis=None):
    """Build the full-corpus ELBO (reduced over ``axis_name`` with a
    ``mesh``; ``vocab_axis`` gathers beta whole first).

    For the structured family the z and w terms collapse to the forward
    log-normaliser: ELBO_d = log Z̃_d + E[log p(pi)] − E[log q(pi)] +
    E[log p(theta)] − E[log q(theta)], evaluated at the current
    parameters, so the trace is monotone."""
    chunks = _chunks(packed, chunk_docs)

    def elbo(state: HMTMState, terms, counts, doc_mask) -> torch.Tensor:
        terms, counts, doc_mask = (as_segments(x) for x in (terms, counts, doc_mask))
        dtype, dev = state.beta.dtype, state.beta.device
        beta = state.beta
        if vocab_axis is not None:
            beta = all_gather(beta, mesh, vocab_axis, dim=1)
        tables = elbo_tables(beta, state.eta, state.alpha)
        acc = kbn_zero(dtype, dev)
        for rows, j, sl in chunks:
            acc = kbn_add(acc, elbo_chunk(tables, terms[j][sl], counts[j][sl],
                                          doc_mask[j][sl], state.tau[rows], state.gamma[rows]))
        return kbn_pack(kbn_psum(acc, mesh, axis_name))

    return elbo


def elbo_tables(beta, eta, alpha) -> tuple:
    """What every chunk of the bound shares: (beta + EPSILON)ᵀ, eta,
    alpha and the documents' constant Dirichlet normalisers."""
    betaT_eps = (beta.T + EPSILON).contiguous()
    pi_const = lgamma(torch.sum(eta)) - torch.sum(lgamma(eta))
    th_const = torch.sum(lgamma(torch.sum(alpha, 0)) - torch.sum(lgamma(alpha), 0))
    return betaT_eps, eta, alpha, pi_const, th_const


def elbo_chunk(tables, t, c, dm, tau, gamma) -> torch.Tensor:
    """One chunk's bound, on any [B, L] chunk, summed over its real
    documents."""
    betaT_eps, eta, alpha, pi_const, th_const = tables
    logZ = hmtm_logz(betaT_eps, t, (c > 0).to(betaT_eps.dtype), tau, gamma)
    Elogpi, Elogth = _elog(tau, gamma)
    e_ppi = pi_const + torch.sum((eta - 1.0) * Elogpi, -1)
    e_pth = th_const + torch.sum((alpha - 1.0) * Elogth, (-2, -1))
    e_qpi = dirichlet_entropy(tau)
    e_qth = torch.sum(dirichlet_entropy(gamma, dim=-2), -1)
    return torch.sum(dm * (logZ + e_ppi + e_pth + e_qpi + e_qth))


def topicdist(state: HMTMState, d=None) -> torch.Tensor:
    """E_q[pi_d]: the document's initial/occupancy topic mixture."""
    t = state.tau if d is None else state.tau[d]
    return t / torch.sum(t, dim=-1, keepdim=True)


def transdist(state: HMTMState, d) -> np.ndarray:
    """E_q[theta_d]: the document's expected topic-transition matrix
    (column l sums to 1: p(z_n = · | z_{n-1} = l))."""
    g = state.gamma[d].detach().cpu().numpy()
    return g / g.sum(axis=-2, keepdims=True)
