"""Filtered latent Dirichlet allocation — batch-synchronous CAVI on one device.

PyTorch port of the JAX package's ``models/flda.py`` on its bucketed
single-device path (reference ``src/fLDA.jl``): LDA plus a per-token
Bernoulli switch between a content word (drawn from a topic) and a
background word (drawn from the corpus-wide ``kappa``), with global
mixture weight ``eta``.

* The per-document E-step fixpoint (fLDA.jl:181-207) runs chunk by chunk
  over the length-bucketed segments through ``kernels/flda_estep``.
* tau/tau_old stay dense ``[M_pad, L]`` at the corpus width before
  bucketing; each segment reads ``tau[rows, :Ls]`` and every column past
  a segment's width is 0.5 after the sweep, as in the JAX package.
* The beta and kappa statistics share ONE deterministic scatter over
  ``[T, K+1]`` rows, the kappa weight in the last column, along the
  chunk's plan (``lda.token_plans``).
* eta, M_total and C_total stay on the device; the step reads none of
  them back to the host.
* On the sequence axis each document's token slots (and its tau columns)
  are split over ranks: the fixpoint runs pass by pass
  (``flda_split_fixpoint``), each pass's [B, K] statistic summed over the
  axis before gamma's update, as the JAX package's XLA body does.

The ELBO is plain PyTorch: the JAX package has no kernel for it.
"""

from __future__ import annotations

import dataclasses

import torch

from ..kernels._build import check_dtype
from ..kernels.flda_estep import flda_estep, flda_split_fixpoint
from ..ops.newton import dirichlet_newton
from ..ops.segment import count_scatter_into
from ..parallel.mesh import axis_tuple
from ..parallel.shard import all_gather, psum, tp_normalize_rows
from ..utils.numerics import (
    EPSILON, bernoulli_entropy, categorical_entropy, dirichlet_entropy,
    dirichlet_ones, finite, kbn_add, kbn_merge, kbn_pack, kbn_psum, kbn_zero, kbn_zeros,
    lgamma,
)
from .lda import _chunks, as_segments, check_modes, token_axes, token_plans, token_reduce


@dataclasses.dataclass
class FLDAState:
    eta: torch.Tensor            # [] global content-word weight
    alpha: torch.Tensor          # [K]
    kappa: torch.Tensor          # [V] background distribution
    kappa_old: torch.Tensor      # [V]
    beta: torch.Tensor           # [K, V] right-stochastic rows
    beta_old: torch.Tensor       # [K, V]
    gamma: torch.Tensor          # [M_pad, K]
    Elogtheta: torch.Tensor      # [M_pad, K]
    Elogtheta_old: torch.Tensor  # [M_pad, K]
    tau: torch.Tensor            # [M_pad, L] per-token content responsibility
    tau_old: torch.Tensor        # [M_pad, L]
    elbo: torch.Tensor           # compensated (hi, lo) bound, shape (2,)


def init(generator: torch.Generator, packed, K: int, dtype=torch.float32,
         device="cpu") -> FLDAState:
    """Constructor state (reference fLDA.jl:30-58).  beta and kappa are
    drawn on ``generator``'s device and then moved to ``device``."""
    M_pad, V, L = packed.M_pad, packed.V, packed.L
    beta = dirichlet_ones(generator, V, (K,), dtype).to(device)
    kappa = dirichlet_ones(generator, V, (), dtype).to(device)
    eta = torch.tensor(0.5, dtype=dtype, device=device)
    # ψ(K) = −γ + H_{K−1} ⇒ el0 = −H_{K−1}, computed on the host
    el0 = -sum(1.0 / i for i in range(1, K))
    El = torch.full((M_pad, K), el0, dtype=dtype, device=device)
    tau = torch.full((M_pad, L), 0.5, dtype=dtype, device=device)
    return FLDAState(
        eta=eta, alpha=torch.ones((K,), dtype=dtype, device=device),
        kappa=kappa, kappa_old=kappa, beta=beta, beta_old=beta,
        gamma=torch.ones((M_pad, K), dtype=dtype, device=device),
        Elogtheta=El, Elogtheta_old=El, tau=tau, tau_old=tau,
        elbo=torch.zeros((2,), dtype=dtype, device=device),
    )


def sweep_chunk(logbetaT, kappa, alpha, eta, terms, counts, doc_mask, gamma, El, El_old,
                tau, tau_old, plan, stat, viter: int, vtol: float,
                elogtheta_f64: bool = False, tok_reduce=None):
    """One chunk of the E-step sweep, on any [B, L] chunk: the fixpoint
    through ``flda_estep``, then beta_temp += phi .* (tau .* counts)'
    (fLDA.jl:174-177) and kappa_temp[terms] += (1 - tau) .* counts
    (fLDA.jl:160-163) as one scatter into ``stat`` [V, K+1] in place.
    Returns the chunk's new (gamma, El, El_old, tau, tau_old), its
    Elogtheta sum [K] and its Σ tau·counts (update_eta!, fLDA.jl:122-124).
    ``elogtheta_f64``: the f64 Elogtheta channel (``lda.make_step``).
    ``tok_reduce`` (the sequence axis) runs the fixpoint pass by pass
    (``flda_split_fixpoint``), each pass's statistic summed by it."""
    args = (logbetaT, kappa, terms, counts, doc_mask, alpha, eta, gamma, El, El_old, tau,
            tau_old)
    if tok_reduce is None:
        g2, el2, elo2, ta2, tao2, w = flda_estep(*args, viter=viter, vtol=vtol,
                                                 elogtheta_f64=elogtheta_f64)
    else:
        g2, el2, elo2, ta2, tao2, w = flda_split_fixpoint(
            *args, viter=viter, vtol=vtol, reduce=tok_reduce, elogtheta_f64=elogtheta_f64)
    count_scatter_into(stat, w.reshape(-1, w.shape[-1]), plan)
    return (g2, el2, elo2, ta2, tao2, torch.sum(el2 * doc_mask[:, None], dim=0),
            torch.sum(ta2 * counts))


def global_update(stat, alpha, El_sum, tau_counts, M_total, C_total, niter: int,
                  ntol: float, El_sum_lo=None):
    """(eta, alpha, kappa, beta) from a sweep's statistics (fLDA.jl:97-156):
    ``stat`` [V, K+1] holds beta_temp and kappa_temp in its last column."""
    K = stat.shape[1] - 1
    bt = stat[:, :K].T.contiguous()
    beta_new = bt / torch.sum(bt, dim=1, keepdim=True)
    kappa_temp = stat[:, K]
    kappa_new = kappa_temp / torch.sum(kappa_temp)              # fLDA.jl:152-156
    alpha_new = dirichlet_newton(alpha, El_sum, M_total, niter, ntol,
                                 Elogtheta_sum_lo=El_sum_lo)
    return tau_counts / C_total, alpha_new, kappa_new, beta_new


def make_step(packed, K: int, viter: int, vtol: float, niter: int, ntol: float,
              chunk_docs: int, device, mesh=None, axis_name=None, vocab_axis=None,
              seq_axis=None, elogtheta_f64: bool = False):
    """Build the outer-iteration step (one full CAVI sweep).

    ``step(state, terms, counts, doc_mask, M_total, C_total)`` takes the
    per-segment tuples of tensors (one tensor each for a dense corpus) and
    two 0-dim tensors on ``device``, and returns the next state; the
    scatter plans and ``mesh``: as in ``lda.make_step`` (Elogtheta_sum,
    tau_counts and the [V, K+1] beta/kappa statistic are summed over
    ``axis_name``).  ``vocab_axis`` shards beta's and kappa's storage
    (``[K, V/n]`` and ``[V/n]`` blocks), gathered whole for the E-step;
    the new blocks come from ``tp_normalize_rows`` of the statistic.
    ``seq_axis`` splits every document's token slots: ``packed`` is the
    slab of this process's rows and token columns (dense), the state's
    tau/tau_old its ``[rows, L/n]`` block (``convert.shard_state``), each
    pass's statistic is summed over ``seq_axis``, and so are the
    token-level statistics (the [V, K+1] block, tau_counts), while
    Elogtheta_sum sums over ``axis_name`` alone (the JAX package's
    models/flda.py:286-293).  ``elogtheta_f64``: ψ of the E-step in
    float64, as in ``lda.make_step`` (the JAX package's
    models/flda.py:106-112).
    """
    check_modes(vocab_axis, seq_axis, False, packed)
    V = packed.V
    chunks = _chunks(packed, chunk_docs)
    plans = token_plans(packed, chunk_docs, device)
    tok_reduce = token_reduce(mesh, seq_axis)
    stat_axes = axis_tuple(axis_name)
    tok_axes = token_axes(axis_name, seq_axis)

    def step(state: FLDAState, terms, counts, doc_mask, M_total, C_total) -> FLDAState:
        terms, counts, doc_mask = (as_segments(x) for x in (terms, counts, doc_mask))
        dtype, dev = state.beta.dtype, state.beta.device
        check_dtype("fLDA", dtype, dev, ("seq",) * (seq_axis is not None))
        beta, kappa = state.beta, state.kappa
        if vocab_axis is not None:
            beta = all_gather(beta, mesh, vocab_axis, dim=1)
            kappa = all_gather(kappa, mesh, vocab_axis, dim=0)
        logbetaT = torch.log(beta + EPSILON).T.contiguous()         # [V, K]
        stat = torch.zeros((V, K + 1), dtype=dtype, device=dev)
        El_sum = kbn_zeros((K,), dtype, dev)          # see models/lda.py
        tau_counts = torch.zeros((), dtype=dtype, device=dev)
        gamma = torch.empty_like(state.gamma)
        El = torch.empty_like(state.Elogtheta)
        El_old = torch.empty_like(state.Elogtheta_old)
        # columns past each segment's width are reset to 0.5
        tau = torch.full_like(state.tau, 0.5)
        tau_old = torch.full_like(state.tau_old, 0.5)
        for (rows, j, sl), plan in zip(chunks, plans):
            t, c, dm = terms[j][sl], counts[j][sl], doc_mask[j][sl]
            Ls = t.shape[1]
            g2, el2, elo2, ta2, tao2, el_part, tau_part = sweep_chunk(
                logbetaT, kappa, state.alpha, state.eta, t, c, dm,
                state.gamma[rows], state.Elogtheta[rows], state.Elogtheta_old[rows],
                state.tau[rows, :Ls].contiguous(), state.tau_old[rows, :Ls].contiguous(),
                plan, stat, viter, vtol, elogtheta_f64, tok_reduce)
            El_sum = kbn_add(El_sum, el_part)
            tau_counts = tau_counts + tau_part
            gamma[rows], El[rows], El_old[rows] = g2, el2, elo2
            tau[rows, :Ls], tau_old[rows, :Ls] = ta2, tao2

        El_sum = kbn_psum(El_sum, mesh, stat_axes)
        tau_counts = psum(tau_counts, mesh, tok_axes)
        if vocab_axis is not None:
            local, sums = tp_normalize_rows(stat, mesh, vocab_axis, tok_axes)
            beta_new = (local[:, :K].T / sums[:K, None]).contiguous()
            kappa_new = local[:, K] / sums[K]
            eta_new = tau_counts / C_total
            alpha_new = dirichlet_newton(state.alpha, El_sum[0], M_total, niter, ntol,
                                         Elogtheta_sum_lo=El_sum[1])
        else:
            eta_new, alpha_new, kappa_new, beta_new = global_update(
                psum(stat, mesh, tok_axes), state.alpha, El_sum[0], tau_counts, M_total,
                C_total, niter, ntol, El_sum[1])
        return FLDAState(
            eta=eta_new, alpha=alpha_new,
            kappa=kappa_new, kappa_old=state.kappa, beta=beta_new, beta_old=state.beta,
            gamma=gamma, Elogtheta=El, Elogtheta_old=El_old, tau=tau, tau_old=tau_old,
            elbo=state.elbo,
        )

    return step


def make_elbo(packed, K: int, chunk_docs: int, mesh=None, axis_name=None, vocab_axis=None,
              seq_axis=None):
    """ELBO with the reference's *_old recompute semantics (fLDA.jl:109-118).

    phi is recomputed from (tau_old, beta_old, Elogtheta_old); the terms
    use the current parameters.  Doc-level and token-level terms ride two
    compensated (hi, lo) accumulators, as in the JAX package, reduced over
    ``axis_name`` with a ``mesh``; ``vocab_axis`` gathers beta, beta_old
    and kappa whole first.  With ``seq_axis`` each chunk's per-document
    token sums (C_d, Σ tau·c, phi@counts) are summed over it before the
    document terms are formed, and only the token accumulator sums over
    it (the JAX package's models/flda.py:371-377, 430-436).
    """
    check_modes(vocab_axis, seq_axis, False, packed)
    chunks = _chunks(packed, chunk_docs)
    tok_reduce = token_reduce(mesh, seq_axis)

    def elbo(state: FLDAState, terms, counts, doc_mask) -> torch.Tensor:
        terms, counts, doc_mask = (as_segments(x) for x in (terms, counts, doc_mask))
        dtype, dev = state.beta.dtype, state.beta.device
        beta, beta_old, kappa = state.beta, state.beta_old, state.kappa
        if vocab_axis is not None:
            beta, beta_old = (all_gather(x, mesh, vocab_axis, dim=1) for x in (beta, beta_old))
            kappa = all_gather(kappa, mesh, vocab_axis, dim=0)
        tables = elbo_tables(beta, beta_old, kappa, state.alpha, state.eta)
        acc_doc, acc_tok = kbn_zero(dtype, dev), kbn_zero(dtype, dev)
        for rows, j, sl in chunks:
            t = terms[j][sl]
            Ls = t.shape[1]
            doc, tok = elbo_chunk(tables, t, counts[j][sl], doc_mask[j][sl],
                                  state.gamma[rows], state.Elogtheta[rows],
                                  state.Elogtheta_old[rows], state.tau[rows, :Ls],
                                  state.tau_old[rows, :Ls], tok_reduce)
            acc_doc = kbn_add(acc_doc, doc)
            acc_tok = kbn_add(acc_tok, tok)
        # the document terms are alike on every rank of the sequence
        # axis: the token pair is summed over it first, then the merged pair
        return kbn_pack(kbn_psum(kbn_merge(acc_doc, kbn_psum(acc_tok, mesh, seq_axis)),
                                 mesh, axis_name))

    return elbo


def elbo_tables(beta, beta_old, kappa, alpha, eta) -> tuple:
    """What every chunk of the bound shares: the log tables and the
    constants of the current parameters."""
    dtype, dev = beta.dtype, beta.device
    logbeta_oldT = torch.log(beta_old + EPSILON).T
    logbetaT = torch.log(beta + EPSILON).T
    logkappa = torch.log(kappa + EPSILON)
    theta_const = finite(lgamma(torch.sum(alpha))) - finite(torch.sum(lgamma(alpha)))
    log_eps = torch.log(torch.tensor(EPSILON, dtype=dtype, device=dev))
    log_eta = torch.log(eta + EPSILON)
    log_1m_eta = torch.log(1.0 - eta + EPSILON)
    return (logbeta_oldT, logbetaT, logkappa, alpha, theta_const, log_eps, log_eta,
            log_1m_eta)


def elbo_chunk(tables, t, c, dm, gamma, el, elo, ta, tao, tok_reduce=None) -> tuple:
    """One chunk's bound, on any [B, L] chunk with its tau/tau_old at the
    chunk's width: (doc terms, token terms), each summed over its real
    documents.  ``tok_reduce`` (the sequence axis) sums the per-document
    token sums over the ranks holding the documents' other slots, in one
    call, before the document terms use them."""
    logbeta_oldT, logbetaT, logkappa, a, theta_const, log_eps, log_eta, log_1m_eta = tables
    # phi recompute from tau_old/beta_old/Elogtheta_old (fLDA.jl:113)
    p = torch.softmax(tao[:, :, None] * logbeta_oldT[t] + elo[:, None, :], dim=-1)
    C_d = torch.sum(c, -1)
    tau_c = torch.sum(ta * c, -1)
    pc = torch.einsum("bl,blk->bk", c, p)
    if tok_reduce is not None:
        sums = tok_reduce(torch.cat([C_d[:, None], tau_c[:, None], pc], dim=1))
        C_d, tau_c, pc = sums[:, 0], sums[:, 1], sums[:, 2:]
    # Elogptheta (fLDA.jl:62-65)
    e_ptheta = theta_const + torch.sum((a - 1.0) * el, -1)
    # Elogpc (fLDA.jl:68-71): log(eta^a (1-eta)^b + EPS), the
    # reference's @boink saturation through logaddexp
    s = tau_c * log_eta + (C_d - tau_c) * log_1m_eta
    e_pc = torch.logaddexp(s, log_eps)
    # Elogpz (fLDA.jl:74-78)
    e_pz = torch.sum(pc * el, -1)
    # Elogpw (fLDA.jl:82-86)
    e_pw = (torch.sum(p * logbetaT[t] * (c * ta)[:, :, None], dim=(1, 2))
            + torch.sum(c * (1.0 - ta) * logkappa[t], dim=-1))
    # −Elogqtheta (fLDA.jl:89-92)
    e_qtheta = dirichlet_entropy(gamma)
    # −Elogqc (fLDA.jl:95-98)
    e_qc = torch.sum(bernoulli_entropy(ta) * c, dim=-1)
    # −Elogqz (fLDA.jl:102-105)
    e_qz = torch.sum(categorical_entropy(p) * c, dim=-1)
    return (torch.sum(dm * (e_ptheta + e_pc + e_pz + e_qtheta)),
            torch.sum(dm * (e_pw + e_qc + e_qz)))

