"""Filtered correlated topic model — batch-synchronous CAVI on one device.

PyTorch port of the JAX package's ``models/fctm.py`` on its bucketed
single-device path (reference ``src/fCTM.jl``): CTM plus fLDA's per-token
Bernoulli switch between a topic word and a background word (tau, kappa).
Two reference quirks are mirrored on purpose:

* the viter order is phi, tau, logzeta, **lambda, then vsq**
  (fCTM.jl:250-256; CTM runs vsq before lambda);
* ``update_eta!`` is commented out of the train loop (fCTM.jl:267), so eta
  stays at its 0.5 initialisation.

tau/tau_old stay dense ``[M_pad, L]`` at the corpus width; each segment
reads ``tau[rows, :Ls]`` and every column past a segment's width is 0.5
after the sweep, as in the JAX package.  The beta and kappa statistics
share one scatter over ``[T, K+1]`` rows, kappa's weight in column K.
The bound is plain PyTorch: the JAX package has no kernel for it.  On the
sequence axis each document's token slots and tau columns are split over
ranks, and the per-document token sums are summed over the axis before
each nonlinear update, as in ``models/ctm.py``.
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops.newton import ctm_lambda_newton, ctm_vsq_newton
from ..ops.segment import count_scatter_into
from ..parallel.shard import all_gather, psum, tp_normalize_rows
from ..utils.numerics import (
    EPSILON, bernoulli_entropy, categorical_entropy, dirichlet_ones, kbn_add, kbn_merge,
    kbn_pack, kbn_psum, kbn_zero, l2norm, logsumexp, masked_fixpoint,
)
from .ctm import beta_rows, gaussian_terms, gaussian_update, logdet_invsigma, moment_sums
from .lda import _chunks, as_segments, check_modes, token_axes, token_plans, token_reduce


@dataclasses.dataclass
class FCTMState:
    eta: torch.Tensor         # [] fixed at 0.5 (fCTM.jl:267)
    mu: torch.Tensor          # [K]
    sigma: torch.Tensor       # [K, K]
    invsigma: torch.Tensor    # [K, K]
    kappa: torch.Tensor       # [V] background distribution
    kappa_old: torch.Tensor   # [V]
    beta: torch.Tensor        # [K, V] right-stochastic rows
    beta_old: torch.Tensor    # [K, V]
    lam: torch.Tensor         # [M_pad, K]
    lam_old: torch.Tensor     # [M_pad, K]
    vsq: torch.Tensor         # [M_pad, K]
    logzeta: torch.Tensor     # [M_pad]
    tau: torch.Tensor         # [M_pad, L] per-token topic-word responsibility
    tau_old: torch.Tensor     # [M_pad, L]
    elbo: torch.Tensor        # compensated (hi, lo) bound, shape (2,)


def init(generator: torch.Generator, packed, K: int, dtype=torch.float32,
         device="cpu") -> FCTMState:
    """Constructor state (reference fCTM.jl:33-64).  beta and kappa are
    drawn on ``generator``'s device and then moved to ``device``."""
    M_pad, V, L = packed.M_pad, packed.V, packed.L
    beta = dirichlet_ones(generator, V, (K,), dtype).to(device)
    kappa = dirichlet_ones(generator, V, (), dtype).to(device)
    eye = torch.eye(K, dtype=dtype, device=device)
    zeros = torch.zeros((M_pad, K), dtype=dtype, device=device)
    tau = torch.full((M_pad, L), 0.5, dtype=dtype, device=device)
    return FCTMState(
        eta=torch.tensor(0.5, dtype=dtype, device=device),
        mu=torch.zeros((K,), dtype=dtype, device=device), sigma=eye, invsigma=eye,
        kappa=kappa, kappa_old=kappa, beta=beta, beta_old=beta, lam=zeros, lam_old=zeros,
        vsq=torch.ones((M_pad, K), dtype=dtype, device=device),
        logzeta=torch.full((M_pad,), 0.5, dtype=dtype, device=device),
        tau=tau, tau_old=tau, elbo=torch.zeros((2,), dtype=dtype, device=device),
    )


def _phi(logbeta_d, tau, lam):
    """phi ∝ exp(tau·log(beta + EPSILON) + lambda), over K (fCTM.jl:230-233)."""
    return torch.softmax(tau[..., None] * logbeta_d + lam[:, None, :], dim=-1)


def estep_chunk(logbetaT, kappa, eta, mu, invsigma, terms, counts, doc_mask, lam,
                lam_old, vsq, logzeta, tau, tau_old, viter, vtol, niter, ntol,
                tok_reduce=None):
    """One chunk's E-step; returns its new per-document state and the rows
    [B, L, K+1] of the fused beta/kappa statistic.  ``tok_reduce`` (the
    sequence axis) sums C once and phi@counts every pass over the ranks
    holding the documents' other slots, as in ``ctm.estep_chunk``."""
    C = torch.sum(counts, dim=-1)
    if tok_reduce is not None:
        C = tok_reduce(C)
    logbeta_d = logbetaT[terms]                     # [B, L, K]
    kappa_d = kappa[terms]                          # [B, L]
    isd = torch.diagonal(invsigma)

    def body(_, carry):
        lam, lam_old, vsq, logzeta, tau, tau_old, active = carry
        upd = active[:, None]
        p = _phi(logbeta_d, tau, lam)                                   # fCTM.jl:230-233
        s = torch.sum(p * logbeta_d, dim=-1)                            # fCTM.jl:221-226
        tau_new = eta / (eta + (1.0 - eta) * kappa_d * torch.exp(-s) + EPSILON)
        tau_old2 = torch.where(upd, tau, tau_old)
        tau2 = torch.where(upd, tau_new, tau)
        logzeta2 = torch.where(active, logsumexp(lam + 0.5 * vsq), logzeta)
        # update_lambda! BEFORE update_vsq!, unlike CTM (fCTM.jl:175-188)
        pc = torch.einsum("bl,blk->bk", counts, p)
        if tok_reduce is not None:
            pc = tok_reduce(pc)
        lam_new = ctm_lambda_newton(lam, vsq, logzeta2, pc, C, mu, invsigma, active,
                                    niter, ntol)
        lam_old2 = torch.where(upd, lam, lam_old)
        lam2 = torch.where(upd, lam_new, lam)
        vsq2 = ctm_vsq_newton(lam2, vsq, logzeta2, C, isd, active, niter, ntol)  # :192-211
        vsq2 = torch.where(upd, vsq2, vsq)
        return (lam2, lam_old2, vsq2, logzeta2, tau2, tau_old2,
                active & (l2norm(lam2 - lam_old2) >= vtol))

    lam, lam_old, vsq, logzeta, tau, tau_old, _ = masked_fixpoint(
        body, (lam, lam_old, vsq, logzeta, tau, tau_old, doc_mask > 0), viter)
    # statistics with the last phi = f(beta, tau_old, lambda_old): beta
    # weighted by tau·counts (fCTM.jl:168-171), kappa by (1 − tau)·counts
    # (fCTM.jl:154-157), in one [B, L, K+1] block
    w = torch.cat([_phi(logbeta_d, tau_old, lam_old) * (tau * counts)[..., None],
                   ((1.0 - tau) * counts)[..., None]], dim=-1)
    return lam, lam_old, vsq, logzeta, tau, tau_old, w


def sweep_chunk(logbetaT, kappa, eta, mu, invsigma, terms, counts, doc_mask, lam, lam_old,
                vsq, logzeta, tau, tau_old, plan, stat, viter, vtol, niter, ntol,
                tok_reduce=None) -> tuple:
    """One chunk of the E-step sweep, on any [B, L] chunk with its
    tau/tau_old at the chunk's width: the fixpoint of :func:`estep_chunk`,
    its [B·L, K+1] rows added into ``stat`` along ``plan``, in place.
    Returns the chunk's new (lam, lam_old, vsq, logzeta, tau, tau_old) and
    its ``ctm.moment_sums``; ``tok_reduce``: the sequence axis."""
    *out, w = estep_chunk(logbetaT, kappa, eta, mu, invsigma, terms, counts, doc_mask, lam,
                          lam_old, vsq, logzeta, tau, tau_old, viter, vtol, niter, ntol,
                          tok_reduce)
    count_scatter_into(stat, w.reshape(-1, w.shape[-1]), plan)
    return (*out, *moment_sums(out[0], out[2], doc_mask))


def global_update(g, stat, vsq_sum, lam_sum, lam_outer, M_total, identify: bool) -> tuple:
    """(mu, sigma, invsigma, kappa, beta) from a sweep's statistics
    (fCTM.jl:122-150); ``stat`` [V, K+1] holds beta_temp and kappa_temp in
    its last column, ``g`` the previous mu.  update_eta! is deliberately
    not run (fCTM.jl:267)."""
    K = stat.shape[1] - 1
    beta_new = beta_rows(stat[:, :K].T.contiguous())
    kappa_temp = stat[:, K]
    kappa_new = kappa_temp / torch.sum(kappa_temp)              # fCTM.jl:146-150
    mu, sigma, invsigma = gaussian_update(g, vsq_sum, lam_sum, lam_outer, M_total, identify)
    return mu, sigma, invsigma, kappa_new, beta_new


def make_step(packed, K: int, viter: int, vtol: float, niter: int, ntol: float,
              chunk_docs: int, device, identify: bool = False, mesh=None, axis_name=None,
              vocab_axis=None, seq_axis=None):
    """Build the outer-iteration step (one full CAVI sweep).

    ``step(state, terms, counts, doc_mask, M_total)`` takes the per-
    segment tuples of device tensors (one tensor each for a dense corpus)
    on ``device`` and returns the next state; the chunks' scatter plans are
    built here and put on ``device``.  ``identify`` and ``mesh``: as in
    ``ctm.make_step``; ``vocab_axis`` shards beta's and kappa's storage as
    in ``flda.make_step``.  ``seq_axis`` splits every document's token
    slots and its tau columns (``packed`` and the state this process's
    slab and blocks), as in ``ctm.make_step`` and ``flda.make_step``: the
    [V, K+1] statistic sums over it, the moments over ``axis_name`` alone
    (the JAX package's models/fctm.py:213-235).
    """
    check_modes(vocab_axis, seq_axis, False, packed)
    V = packed.V
    chunks = _chunks(packed, chunk_docs)
    plans = token_plans(packed, chunk_docs, device)
    tok_reduce = token_reduce(mesh, seq_axis)
    tok_axes = token_axes(axis_name, seq_axis)

    def step(state: FCTMState, terms, counts, doc_mask, M_total) -> FCTMState:
        terms, counts, doc_mask = (as_segments(x) for x in (terms, counts, doc_mask))
        dt, dev = state.beta.dtype, state.beta.device
        beta, kappa = state.beta, state.kappa
        if vocab_axis is not None:
            beta = all_gather(beta, mesh, vocab_axis, dim=1)
            kappa = all_gather(kappa, mesh, vocab_axis, dim=0)
        logbetaT = torch.log(beta + EPSILON).T.contiguous()         # fCTM.jl:232
        stat = torch.zeros((V, K + 1), dtype=dt, device=dev)
        vsq_sum = torch.zeros((K,), dtype=dt, device=dev)
        lam_sum = torch.zeros((K,), dtype=dt, device=dev)
        lam_outer = torch.zeros((K, K), dtype=dt, device=dev)
        new = {f: torch.empty_like(getattr(state, f))
               for f in ("lam", "lam_old", "vsq", "logzeta")}
        # columns past each segment's width are reset to 0.5
        tau = torch.full_like(state.tau, 0.5)
        tau_old = torch.full_like(state.tau_old, 0.5)
        for (rows, j, sl), plan in zip(chunks, plans):
            t = terms[j][sl]
            Ls = t.shape[1]
            *out, ta2, tao2, ls, vs, lo = sweep_chunk(
                logbetaT, kappa, state.eta, state.mu, state.invsigma, t, counts[j][sl],
                doc_mask[j][sl], state.lam[rows], state.lam_old[rows], state.vsq[rows],
                state.logzeta[rows], state.tau[rows, :Ls], state.tau_old[rows, :Ls], plan,
                stat, viter, vtol, niter, ntol, tok_reduce)
            lam_sum = lam_sum + ls
            vsq_sum = vsq_sum + vs
            lam_outer = lam_outer + lo
            for f, x in zip(new, out):
                new[f][rows] = x
            tau[rows, :Ls], tau_old[rows, :Ls] = ta2, tao2

        vsq_sum, lam_sum, lam_outer = (
            psum(x, mesh, axis_name) for x in (vsq_sum, lam_sum, lam_outer))
        if vocab_axis is not None:
            local, sums = tp_normalize_rows(stat, mesh, vocab_axis, tok_axes)
            beta_new = beta_rows(local[:, :K].T.contiguous(), sums[:K, None])
            kappa_new = local[:, K] / sums[K]
            mu, sigma, invsigma = gaussian_update(state, vsq_sum, lam_sum, lam_outer,
                                                  M_total, identify)
        else:
            mu, sigma, invsigma, kappa_new, beta_new = global_update(
                state, psum(stat, mesh, tok_axes), vsq_sum, lam_sum, lam_outer, M_total,
                identify)
        return FCTMState(eta=state.eta, mu=mu, sigma=sigma, invsigma=invsigma,
                         kappa=kappa_new, kappa_old=state.kappa, beta=beta_new,
                         beta_old=state.beta, tau=tau, tau_old=tau_old, elbo=state.elbo,
                         **new)

    return step


def make_elbo(packed, K: int, chunk_docs: int, mesh=None, axis_name=None, vocab_axis=None,
              seq_axis=None):
    """ELBO (fCTM.jl:67-124): phi recomputed from (tau_old, beta_old,
    lambda_old), the terms with the current parameters; doc-level and
    token-level terms ride two compensated accumulators.  ``vocab_axis``
    gathers beta, beta_old and kappa whole first.  With ``seq_axis`` each
    chunk's per-document token sums (C_d, Σ tau·c, phi@counts) are summed
    over it before the document terms use them, and only the token
    accumulator sums over it (the JAX package's models/fctm.py:309-315,
    370-372)."""
    check_modes(vocab_axis, seq_axis, False, packed)
    chunks = _chunks(packed, chunk_docs)
    tok_reduce = token_reduce(mesh, seq_axis)

    def elbo(state: FCTMState, terms, counts, doc_mask) -> torch.Tensor:
        terms, counts, doc_mask = (as_segments(x) for x in (terms, counts, doc_mask))
        dt, dev = state.beta.dtype, state.beta.device
        g = state
        if vocab_axis is not None:
            g = dataclasses.replace(
                state, beta=all_gather(state.beta, mesh, vocab_axis, dim=1),
                beta_old=all_gather(state.beta_old, mesh, vocab_axis, dim=1),
                kappa=all_gather(state.kappa, mesh, vocab_axis, dim=0))
        tables = elbo_tables(g)
        acc_doc, acc_tok = kbn_zero(dt, dev), kbn_zero(dt, dev)
        for rows, j, sl in chunks:
            t = terms[j][sl]
            Ls = t.shape[1]
            doc, tok = elbo_chunk(tables, t, counts[j][sl], doc_mask[j][sl], state.lam[rows],
                                  state.lam_old[rows], state.vsq[rows], state.logzeta[rows],
                                  state.tau[rows, :Ls], state.tau_old[rows, :Ls], tok_reduce)
            acc_doc = kbn_add(acc_doc, doc)
            acc_tok = kbn_add(acc_tok, tok)
        # the document terms are alike on every rank of the sequence
        # axis: the token pair is summed over it first, then the merged pair
        return kbn_pack(kbn_psum(kbn_merge(acc_doc, kbn_psum(acc_tok, mesh, seq_axis)),
                                 mesh, axis_name))

    return elbo


def elbo_tables(g) -> tuple:
    """What every chunk of the bound shares, from the globals ``g`` (any
    object with the FCTMState global fields)."""
    dt, dev = g.beta.dtype, g.beta.device
    log_eps = torch.log(torch.tensor(EPSILON, dtype=dt, device=dev))
    return (torch.log(g.beta_old + EPSILON).T, torch.log(g.beta + EPSILON).T,
            torch.log(g.kappa + EPSILON), log_eps, torch.log(g.eta + EPSILON),
            torch.log(1.0 - g.eta + EPSILON), logdet_invsigma(g), g)


def elbo_chunk(tables, t, c, dm, la, lao, v, lz, ta, tao, tok_reduce=None) -> tuple:
    """One chunk's bound, on any [B, L] chunk with its tau/tau_old at the
    chunk's width: (doc terms, token terms), each summed over its real
    documents; ``tok_reduce`` (the sequence axis) sums the per-document
    token sums over the ranks, in one call, before the document terms."""
    logbeta_oldT, logbetaT, logkappa, log_eps, log_eta, log_1m_eta, logdet_inv, g = tables
    K = la.shape[1]
    cd = torch.sum(c, dim=-1)
    p = _phi(logbeta_oldT[t], tao, lao)
    tau_c = torch.sum(ta * c, -1)
    pc = torch.einsum("bl,blk->bk", c, p)
    if tok_reduce is not None:
        sums = tok_reduce(torch.cat([cd[:, None], tau_c[:, None], pc], dim=1))
        cd, tau_c, pc = sums[:, 0], sums[:, 1], sums[:, 2:]
    # Elogpc (fCTM.jl:74-78): log(eta^a (1-eta)^b + EPS) by logaddexp
    e_pc = torch.logaddexp(tau_c * log_eta + (cd - tau_c) * log_1m_eta, log_eps)
    # Elogpeta − Elogqeta (fCTM.jl:68-71, 95-98) and Elogpz (fCTM.jl:81-85)
    e_gauss = gaussian_terms(g, la, v, lz, cd, K, logdet_inv) + torch.sum(pc * la, -1)
    # Elogpw (fCTM.jl:88-92)
    e_pw = (torch.sum(p * logbetaT[t] * (c * ta)[..., None], dim=(1, 2))
            + torch.sum(c * (1.0 - ta) * logkappa[t], dim=-1))
    e_qc = torch.sum(bernoulli_entropy(ta) * c, dim=-1)         # fCTM.jl:101-105
    e_qz = torch.sum(categorical_entropy(p) * c, dim=-1)        # fCTM.jl:108-112
    return torch.sum(dm * (e_gauss + e_pc)), torch.sum(dm * (e_pw + e_qc + e_qz))
