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
  (LDA.jl:129-132) is a deterministic scatter (ops/segment.py) along one
  plan per chunk, built once per trainer (:func:`token_plans`), and alpha's Newton
  (LDA.jl:97-118) runs on the same device.

The E-step, the scatter and the ELBO's token terms go through
``kernels/``: a CUDA tensor launches the hand-written kernel, a CPU
tensor runs its plain PyTorch version.  Nothing else selects a path.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..kernels._build import check_dtype
from ..kernels.lda_elbo import lda_elbo_tok
from ..kernels.lda_estep import lda_estep, split_fixpoint
from ..kernels.scatter_rows import build_plan
from ..ops.newton import dirichlet_newton
from ..ops.packing import RoutedCorpus, seg_loc_starts
from ..ops.segment import count_scatter_into
from ..parallel.mesh import axis_tuple
from ..parallel.shard import all_gather, psum, tp_normalize_rows
from ..utils.numerics import (
    EPSILON, dirichlet_entropy, dirichlet_ones, finite, kbn_add, kbn_merge,
    kbn_pack, kbn_psum, kbn_zero, kbn_zeros, lgamma,
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
    in sweep order: of each segment of a bucketed corpus, or of the rows
    of a dense one (a PackedCorpus or a RoutedCorpus, one segment)."""
    seg_starts = seg_loc_starts(packed)
    if seg_starts is None:
        n_rows = packed.terms.shape[0]
        B = min(chunk_docs, n_rows)
        if B == 0 or n_rows % B:
            raise ValueError(f"the packed doc axis {n_rows} does not divide into "
                             f"chunks of {B}")
        return [(slice(lo, lo + B), 0, slice(lo, lo + B)) for lo in range(0, n_rows, B)]
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


def segments(packed) -> list:
    """The (terms, counts) host arrays of each segment: a bucketed
    corpus's segments, or the whole of a dense one."""
    if packed.segments is None:
        return [(packed.terms, packed.counts)]
    return [(s.terms, s.counts) for s in packed.segments]


def as_segments(x) -> tuple:
    """A step's per-segment tensors: a dense corpus's one tensor becomes
    a tuple of one."""
    return (x,) if isinstance(x, torch.Tensor) else x


def token_plans(packed, chunk_docs: int, device) -> list:
    """One scatter plan per chunk, in sweep order, over its token slots
    with ``counts > 0``: built from the host arrays, put on ``device``."""
    segs = segments(packed)
    return [build_plan(segs[j][0][sl], segs[j][1][sl] > 0).to(device)
            for _, j, sl in _chunks(packed, chunk_docs)]


def token_reduce(mesh, axis):
    """The per-document reduction of a split token axis: the psum over
    ``axis`` of the ranks holding a document's other slots, or None when
    the slots are whole."""
    return None if axis is None else (lambda x: psum(x, mesh, axis))


def token_axes(axis_name, seq_axis) -> tuple:
    """The axes a token-level statistic sums over: the data axes, and
    ``seq_axis`` too when the token slots are split over it."""
    return axis_tuple(axis_name) + axis_tuple(seq_axis)


def check_modes(vocab_axis, seq_axis, vocab_routed, packed) -> None:
    """The JAX package's exclusivity rules for the tensor- and
    sequence-parallel modes (every family's: a split token axis needs
    dense packing)."""
    if vocab_routed:
        if vocab_axis is None:
            raise ValueError("vocab_routed requires a vocab_axis")
        if seq_axis is not None:
            raise ValueError("vocab_routed and seq_axis are exclusive "
                             "(routing already splits the token axis)")
        if not isinstance(packed, RoutedCorpus):
            raise ValueError("vocab_routed takes a RoutedCorpus (ops/packing.route_packed)")
    if (vocab_routed or seq_axis is not None) and packed.segments is not None:
        raise ValueError("token-axis sharding requires dense packing")


def sweep_chunk(betaT, alpha, terms, counts, doc_mask, gamma, El, El_old, plan, beta_temp,
                viter: int, vtol: float, tok_reduce=None, elogtheta_f64: bool = False):
    """One chunk of the E-step sweep, on any [B, L] chunk: the fixpoint
    through ``lda_estep``, its rows ``phi·counts`` added into
    ``beta_temp`` [V, K] in place along ``plan``.  Returns the chunk's new
    (gamma, El, El_old) and its Elogtheta sum [K] over real documents.

    ``tok_reduce`` (the token slots split over ranks: routed tensor
    parallelism, the sequence axis) runs the fixpoint pass by pass
    instead (``split_fixpoint``), each pass's statistic summed by it.
    ``elogtheta_f64`` takes the fixpoint's ψ in float64 (the kernel's
    f64-channel mode, or on the tiles in ``split_fixpoint``)."""
    if tok_reduce is None:
        g2, el2, elo2, w = lda_estep(betaT, terms, counts, doc_mask, alpha, gamma, El,
                                     El_old, viter=viter, vtol=vtol,
                                     elogtheta_f64=elogtheta_f64)
    else:
        g2, el2, elo2, w = split_fixpoint(betaT, terms, counts, doc_mask, alpha, gamma, El,
                                          El_old, viter=viter, vtol=vtol, reduce=tok_reduce,
                                          elogtheta_f64=elogtheta_f64)
    count_scatter_into(beta_temp, w.reshape(-1, w.shape[-1]), plan)
    return g2, el2, elo2, torch.sum(el2 * doc_mask[:, None], dim=0)


def global_beta(beta_temp) -> torch.Tensor:
    """update_beta!'s reset (LDA.jl:121-125): beta [K, V] from beta_temp
    [V, K], rows normalised."""
    bt = beta_temp.T.contiguous()
    return bt / torch.sum(bt, dim=1, keepdim=True)


def global_update(beta_temp, alpha, El_sum, M_total, niter: int, ntol: float,
                  El_sum_lo=None):
    """(beta, alpha) from a sweep's statistics: update_beta!'s reset
    (LDA.jl:121-125) and update_alpha!'s Newton (LDA.jl:97-118), the lo
    half of a compensated El_sum entering its mean-form gradient."""
    beta_new = global_beta(beta_temp)
    alpha_new = dirichlet_newton(alpha, El_sum, M_total, niter, ntol,
                                 Elogtheta_sum_lo=El_sum_lo)
    return beta_new, alpha_new


def make_step(packed, K: int, viter: int, vtol: float, niter: int, ntol: float,
              chunk_docs: int, device, mesh=None, axis_name=None,
              vocab_axis=None, seq_axis=None, vocab_routed: bool = False,
              elogtheta_f64: bool = False):
    """Build the outer-iteration step (one full CAVI sweep).

    ``step(state, terms, counts, doc_mask, M_total)`` takes device
    tensors on ``device``: per-segment tuples for a bucketed corpus, one
    tensor each for a dense one.  It returns the next state; the chunks'
    scatter plans are built here and put on ``device``.  With a ``mesh``,
    ``packed`` is this process's slab, and the statistics (Elogtheta_sum,
    beta_temp) are summed over ``axis_name`` (a mesh axis or a tuple of
    axes) before the M-step, which every process then runs alike.

    The JAX package's tensor- and sequence-parallel modes, on a ``mesh``
    carrying their axes:

    * ``vocab_axis`` shards beta's storage: ``state.beta`` is this
      process's ``[K, V/n]`` block, gathered whole for the E-step, and the
      new block comes from ``tp_normalize_rows``.  The documents shard
      over the data axes, so include the vocab axis in ``axis_name``.
    * ``vocab_routed=True`` (with a ``vocab_axis``): ``packed`` is this
      process's slab of a ``RoutedCorpus`` (its rows and its vocab
      block's slot columns, shard-local ids), beta is never gathered,
      each pass's ``[B, K]`` statistic is summed over the vocab axis
      (``split_fixpoint``) and the statistic scatters into the local
      ``[V/n, K]`` block.  ``axis_name`` names the data axes only.
    * ``seq_axis`` splits every document's token slots: ``packed`` is
      the slab of this process's rows and token columns (dense), and each
      pass's statistic is summed over ``seq_axis``.

    ``elogtheta_f64`` runs the E-step's gamma → Elogtheta channel in
    float64 on the float32 state (``RuntimeConfig.elogtheta_f64``, the
    JAX package's models/lda.py:133-141): ψ(γ) − ψ(Σγ) in float64, cast
    back; the token-level work stays float32.  On the card it is a mode of
    the ``lda_estep`` kernel; no switch like JAX's ``jax_enable_x64`` is
    needed.
    """
    check_modes(vocab_axis, seq_axis, vocab_routed, packed)
    # vocab extent of the gather table and the statistic: the local block
    # under routing, the whole vocabulary otherwise
    V_local = packed.Vs if vocab_routed else packed.V
    # the per-pass [B, K] reduction: over the vocab axis under routing
    # (each block holds only its tokens), the sequence axis under SP
    tok_axis = vocab_axis if vocab_routed else seq_axis
    tok_reduce = token_reduce(mesh, tok_axis)
    stat_axes = axis_tuple(axis_name)
    if vocab_routed:
        # documents replicate across the vocab axis: doc-level statistics
        # reduce over the data axes alone
        stat_axes = tuple(a for a in stat_axes if a != vocab_axis)
    # the token-local statistic also sums the sequence shards
    stat_axes_bt = token_axes(stat_axes, seq_axis)
    chunks = _chunks(packed, chunk_docs)
    plans = token_plans(packed, chunk_docs, device)

    # the axes that split the token slots, for the dtype gate
    split_axes = ("routed",) * vocab_routed + ("seq",) * (seq_axis is not None)

    def step(state: LDAState, terms, counts, doc_mask, M_total) -> LDAState:
        terms, counts, doc_mask = (as_segments(x) for x in (terms, counts, doc_mask))
        dtype, dev = state.beta.dtype, state.beta.device
        check_dtype("LDA", dtype, dev, split_axes)
        beta = state.beta
        if vocab_axis is not None and not vocab_routed:
            beta = all_gather(beta, mesh, vocab_axis, dim=1)
        betaT = (beta + EPSILON).T.contiguous()                 # [V_local, K]
        beta_temp = torch.zeros((V_local, K), dtype=dtype, device=dev)
        # Elogtheta_sum rides a compensated (hi, lo) carry: its chunk-
        # sequential f32 accumulation is the dominant training-noise
        # channel, which the Newton amplifies by ~alpha² and the bound
        # re-multiplies by El_sum
        El_sum = kbn_zeros((K,), dtype, dev)
        gamma = torch.empty_like(state.gamma)
        El = torch.empty_like(state.Elogtheta)
        El_old = torch.empty_like(state.Elogtheta_old)
        for (rows, j, sl), plan in zip(chunks, plans):
            t, c, dm = terms[j][sl], counts[j][sl], doc_mask[j][sl]
            g2, el2, elo2, el_part = sweep_chunk(
                betaT, state.alpha, t, c, dm, state.gamma[rows], state.Elogtheta[rows],
                state.Elogtheta_old[rows], plan, beta_temp, viter, vtol, tok_reduce,
                elogtheta_f64)
            El_sum = kbn_add(El_sum, el_part)
            gamma[rows], El[rows], El_old[rows] = g2, el2, elo2

        El_sum = kbn_psum(El_sum, mesh, stat_axes)
        if vocab_routed:
            # every term id lives on one block: only the [K] row sums
            # that make the rows stochastic over the whole vocabulary
            # cross the vocab axis
            beta_temp = psum(beta_temp, mesh, stat_axes)
            row_sum = psum(torch.sum(beta_temp, dim=0), mesh, vocab_axis)
            beta_new = beta_temp.T / row_sum[:, None]
        elif vocab_axis is not None:
            bt_local, row_sum = tp_normalize_rows(beta_temp, mesh, vocab_axis, stat_axes_bt)
            beta_new = bt_local.T / row_sum[:, None]
        else:
            beta_new = global_beta(psum(beta_temp, mesh, stat_axes_bt))
        alpha_new = dirichlet_newton(state.alpha, El_sum[0], M_total, niter, ntol,
                                     Elogtheta_sum_lo=El_sum[1])
        return LDAState(
            alpha=alpha_new, beta=beta_new.contiguous(), beta_old=state.beta,
            gamma=gamma, Elogtheta=El, Elogtheta_old=El_old, elbo=state.elbo,
        )

    return step


def make_elbo(packed, K: int, chunk_docs: int, mesh=None, axis_name=None,
              vocab_axis=None, seq_axis=None, vocab_routed: bool = False):
    """Build the full-corpus ELBO (reference LDA.jl:50-93).

    phi is recomputed from (beta_old, Elogtheta_old) exactly as
    update_elbo! does (LDA.jl:83-93); the five terms use the *current*
    alpha/beta/gamma/Elogtheta, mirroring check_elbo! running after the
    M-step (modelutils.jl:574-585).  The token terms go through
    ``lda_elbo_tok``; the doc-level terms are [B, K] tensor ops.  With a
    ``mesh``, each process sums its slab and the pairs are reduced over
    ``axis_name`` (``kbn_psum``).

    The modes as in :func:`make_step`: ``vocab_axis`` gathers beta and
    beta_old whole; under ``vocab_routed`` the tables are the local
    blocks, and under either split of the token slots (routing,
    ``seq_axis``) the token terms, linear in each slot's share, sum over
    the data axes and the token axis while the document terms sum over
    the data axes alone.
    """
    check_modes(vocab_axis, seq_axis, vocab_routed, packed)
    chunks = _chunks(packed, chunk_docs)
    axes = axis_tuple(axis_name)
    tok_axis = vocab_axis if vocab_routed else seq_axis
    if vocab_routed:
        axes = tuple(a for a in axes if a != vocab_axis)

    def elbo(state: LDAState, terms, counts, doc_mask) -> torch.Tensor:
        terms, counts, doc_mask = (as_segments(x) for x in (terms, counts, doc_mask))
        dtype, dev = state.beta.dtype, state.beta.device
        beta, beta_old = state.beta, state.beta_old
        if vocab_axis is not None and not vocab_routed:
            beta = all_gather(beta, mesh, vocab_axis, dim=1)
            beta_old = all_gather(beta_old, mesh, vocab_axis, dim=1)
        tables = elbo_tables(beta, beta_old, state.alpha)
        # the bound rides a compensated (hi, lo) pair end to end, so the
        # reference's tol=1.0 stop (LDA.jl:161) stays reachable in f32
        acc_doc, acc_tok = kbn_zero(dtype, dev), kbn_zero(dtype, dev)
        for rows, j, sl in chunks:
            doc, tok = elbo_chunk(tables, terms[j][sl], counts[j][sl], doc_mask[j][sl],
                                  state.gamma[rows], state.Elogtheta[rows],
                                  state.Elogtheta_old[rows])
            acc_doc = kbn_add(acc_doc, doc)
            acc_tok = kbn_add(acc_tok, tok)
        # the document terms are alike on every rank of the token axis:
        # the token pair is summed over it first, then the merged pair
        return kbn_pack(kbn_psum(kbn_merge(acc_doc, kbn_psum(acc_tok, mesh, tok_axis)),
                                 mesh, axes))

    return elbo


def elbo_tables(beta, beta_old, alpha) -> tuple:
    """What every chunk of the bound shares: ``lda_elbo_tok``'s tables
    (beta_old + EPSILON)ᵀ and boT·(log(beta + EPSILON) − log boT), alpha
    and Elogptheta's doc-constant part (LDA.jl:50-53)."""
    boT = (beta_old + EPSILON).T.contiguous()               # [V, K]
    dlogT = torch.log(beta + EPSILON).T - torch.log(boT)
    g2T = (boT * dlogT).contiguous()
    theta_const = finite(lgamma(torch.sum(alpha))) - finite(torch.sum(lgamma(alpha)))
    return boT, g2T, alpha, theta_const


def elbo_chunk(tables, terms, counts, doc_mask, gamma, El, El_old) -> tuple:
    """One chunk's bound, on any [B, L] chunk: (doc terms, token terms),
    each summed over its real documents."""
    boT, g2T, a, theta_const = tables
    tok = lda_elbo_tok(boT, g2T, terms, counts, doc_mask, El, El_old)
    e_ptheta = theta_const + torch.sum((a - 1.0) * El, -1)
    e_qtheta = dirichlet_entropy(gamma)
    return torch.sum(doc_mask * (e_ptheta + e_qtheta)), tok


def topicdist(state: LDAState, d=None) -> torch.Tensor:
    """Normalised gamma (reference modelutils.jl:946-951)."""
    g = state.gamma if d is None else state.gamma[d]
    return g / torch.sum(g, dim=-1, keepdim=True)


def topics_ranking(beta: torch.Tensor) -> np.ndarray:
    """Top-terms permutation per topic (LDA.jl:189), 1-based like the reference."""
    return np.argsort(-beta.detach().cpu().numpy(), axis=1, kind="stable") + 1
