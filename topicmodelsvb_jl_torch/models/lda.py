"""Latent Dirichlet allocation — batch-synchronous CAVI on one device.

PyTorch port of the JAX package's ``models/lda.py`` on its single-device
path (reference ``src/LDA.jl`` and its GPU twin ``src/gpuLDA.jl``):

* The per-document E-step fixpoint (LDA.jl:169-180) runs chunk by chunk
  over the length-bucketed segments, each document frozen once it
  converges, which reproduces the reference's per-document sweep: beta
  and alpha only change after the full sweep.
* phi is never stored across iterations; it is recomputed from
  (beta, Elogtheta), the warm-start identity of LDA.jl:87.
* The M-step statistic ``beta_temp[:, terms] += phi .* counts'``
  (LDA.jl:129-132) is a deterministic scatter (ops/segment.py), and
  alpha's Newton (LDA.jl:97-118) runs on the same device.

The E-step and the ELBO's token terms go through ``kernels/``: a CUDA
tensor launches the hand-written kernel, a CPU tensor runs its plain
PyTorch version.  Nothing else selects a path.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..kernels.lda_elbo import lda_elbo_tok
from ..kernels.lda_estep import lda_estep
from ..ops.newton import dirichlet_newton
from ..ops.packing import seg_loc_starts
from ..ops.segment import count_scatter_into
from ..utils.numerics import (
    EPSILON, dirichlet_entropy, dirichlet_ones, finite, kbn_add, kbn_merge,
    kbn_pack, kbn_zero, kbn_zeros, lgamma,
)


@dataclasses.dataclass
class LDAState:
    alpha: torch.Tensor          # [K]
    beta: torch.Tensor           # [K, V] right-stochastic rows
    beta_old: torch.Tensor       # [K, V]
    gamma: torch.Tensor          # [M_pad, K]
    Elogtheta: torch.Tensor      # [M_pad, K]
    Elogtheta_old: torch.Tensor  # [M_pad, K]
    elbo: torch.Tensor           # compensated (hi, lo) bound, shape (2,)


def init(generator: torch.Generator, packed, K: int, dtype=torch.float32,
         device="cpu") -> LDAState:
    """Constructor state (reference LDA.jl:24-47).  beta is drawn on
    ``generator``'s device and then moved to ``device``."""
    M_pad, V = packed.M_pad, packed.V
    beta = dirichlet_ones(generator, V, (K,), dtype).to(device)
    # Elogtheta init: −γ_euler − ψ(K) (LDA.jl:38); ψ(K) = −γ + H_{K−1}
    # for integer K, so el0 = −H_{K−1}, computed on the host
    el0 = -sum(1.0 / i for i in range(1, K))
    Elogtheta = torch.full((M_pad, K), el0, dtype=dtype, device=device)
    return LDAState(
        alpha=torch.ones((K,), dtype=dtype, device=device),
        beta=beta,
        beta_old=beta,
        gamma=torch.ones((M_pad, K), dtype=dtype, device=device),
        Elogtheta=Elogtheta,
        Elogtheta_old=Elogtheta,
        elbo=torch.zeros((2,), dtype=dtype, device=device),
    )


def _chunks(packed, chunk_docs: int):
    """(state row range, segment index, segment row range) of every chunk
    of a bucketed corpus, in sweep order."""
    seg_starts = seg_loc_starts(packed)
    if seg_starts is None:
        raise ValueError("the LDA step runs on a bucketed corpus "
                         "(ops/packing.bucketize_packed)")
    out = []
    for j, (lo, seg) in enumerate(zip(seg_starts, packed.segments)):
        n_rows = seg.terms.shape[0]
        B = min(chunk_docs, n_rows)
        if n_rows % B:
            raise ValueError(f"segment of {n_rows} rows does not divide into "
                             f"chunks of {B}")
        for i in range(n_rows // B):
            out.append((slice(lo + i * B, lo + (i + 1) * B), j,
                        slice(i * B, (i + 1) * B)))
    if sum(s.terms.shape[0] for s in packed.segments) != packed.M_pad:
        raise ValueError("segments must cover every packed row")
    return out


def make_step(packed, K: int, viter: int, vtol: float, niter: int, ntol: float,
              chunk_docs: int):
    """Build the outer-iteration step (one full CAVI sweep).

    ``step(state, terms, counts, doc_mask, M_total)`` takes the per-
    segment tuples of device tensors and returns the next state.
    """
    V = packed.V
    chunks = _chunks(packed, chunk_docs)

    def step(state: LDAState, terms, counts, doc_mask, M_total) -> LDAState:
        dtype, dev = state.beta.dtype, state.beta.device
        betaT = (state.beta + EPSILON).T.contiguous()           # [V, K]
        beta_temp = torch.zeros((V, K), dtype=dtype, device=dev)
        # Elogtheta_sum rides a compensated (hi, lo) carry: its chunk-
        # sequential f32 accumulation is the dominant training-noise
        # channel, which the Newton amplifies by ~alpha² and the bound
        # re-multiplies by El_sum
        El_sum = kbn_zeros((K,), dtype, dev)
        gamma = torch.empty_like(state.gamma)
        El = torch.empty_like(state.Elogtheta)
        El_old = torch.empty_like(state.Elogtheta_old)
        for rows, j, sl in chunks:
            t, c, dm = terms[j][sl], counts[j][sl], doc_mask[j][sl]
            g2, el2, elo2, w = lda_estep(
                betaT, t, c, dm, state.alpha, state.gamma[rows],
                state.Elogtheta[rows], state.Elogtheta_old[rows],
                viter=viter, vtol=vtol)
            count_scatter_into(beta_temp, w.reshape(-1, K), t.reshape(-1))
            El_sum = kbn_add(El_sum, torch.sum(el2 * dm[:, None], dim=0))
            gamma[rows], El[rows], El_old[rows] = g2, el2, elo2

        # update_beta! reset (LDA.jl:121-125)
        bt = beta_temp.T.contiguous()
        beta_new = bt / torch.sum(bt, dim=1, keepdim=True)
        # update_alpha! (LDA.jl:97-118); the lo half of the compensated
        # El_sum enters the Newton's mean-form gradient at full precision
        alpha_new = dirichlet_newton(state.alpha, El_sum[0], M_total,
                                     niter, ntol, Elogtheta_sum_lo=El_sum[1])
        return LDAState(
            alpha=alpha_new, beta=beta_new, beta_old=state.beta,
            gamma=gamma, Elogtheta=El, Elogtheta_old=El_old, elbo=state.elbo,
        )

    return step


def make_elbo(packed, K: int, chunk_docs: int):
    """Build the full-corpus ELBO (reference LDA.jl:50-93).

    phi is recomputed from (beta_old, Elogtheta_old) exactly as
    update_elbo! does (LDA.jl:83-93); the five terms use the *current*
    alpha/beta/gamma/Elogtheta, mirroring check_elbo! running after the
    M-step (modelutils.jl:574-585).  The token terms go through
    ``lda_elbo_tok``; the doc-level terms are [B, K] tensor ops.
    """
    chunks = _chunks(packed, chunk_docs)

    def elbo(state: LDAState, terms, counts, doc_mask) -> torch.Tensor:
        dtype, dev = state.beta.dtype, state.beta.device
        boT = (state.beta_old + EPSILON).T.contiguous()         # [V, K]
        dlogT = torch.log(state.beta + EPSILON).T - torch.log(boT)
        g2T = (boT * dlogT).contiguous()
        a = state.alpha
        # Elogptheta doc-constant part (LDA.jl:50-53)
        theta_const = finite(lgamma(torch.sum(a))) - finite(torch.sum(lgamma(a)))
        # the bound rides a compensated (hi, lo) pair end to end, so the
        # reference's tol=1.0 stop (LDA.jl:161) stays reachable in f32
        acc_doc, acc_tok = kbn_zero(dtype, dev), kbn_zero(dtype, dev)
        for rows, j, sl in chunks:
            t, c, dm = terms[j][sl], counts[j][sl], doc_mask[j][sl]
            el, elo = state.Elogtheta[rows], state.Elogtheta_old[rows]
            tok = lda_elbo_tok(boT, g2T, t, c, dm, el, elo)
            e_ptheta = theta_const + torch.sum((a - 1.0) * el, -1)
            e_qtheta = dirichlet_entropy(state.gamma[rows])
            acc_doc = kbn_add(acc_doc, torch.sum(dm * (e_ptheta + e_qtheta)))
            acc_tok = kbn_add(acc_tok, tok)
        return kbn_pack(kbn_merge(acc_doc, acc_tok))

    return elbo


def topicdist(state: LDAState, d=None) -> torch.Tensor:
    """Normalised gamma (reference modelutils.jl:946-951)."""
    g = state.gamma if d is None else state.gamma[d]
    return g / torch.sum(g, dim=-1, keepdim=True)


def topics_ranking(beta: torch.Tensor) -> np.ndarray:
    """Top-terms permutation per topic (LDA.jl:189), 1-based like the reference."""
    return np.argsort(-beta.detach().cpu().numpy(), axis=1, kind="stable") + 1
