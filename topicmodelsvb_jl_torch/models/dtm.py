"""Dynamic topic model — Blei/Lafferty DTM by CAVI on one device.

PyTorch port of the JAX package's ``models/dtm.py`` on its single-device
path (reference ``v0.6/src/DTM.jl``).  The corpus is cut into T slices
of width ``delta`` by document stamp; the topic-word log-probabilities
evolve over the slices as a Gaussian state-space model whose posterior is
a variational Kalman smoother over the pseudo-observations ``betahat``
(updateMbeta!/updateVbeta!, DTM.jl:209-242); documents follow the LDA
E-step against their slice's smoothed ``mbeta`` with a logzeta softmax
bound (updatePhi!/updateLzeta!, DTM.jl:204-309).

* The smoothers' ``lax.scan``s over T become Python loops over T of
  [K, V] tensor operations (T is 12 at mac scale).
* The M-step statistics go through the ``scatter_rows`` kernel along
  plans built once per trainer: ``A[t·V + v, k] = Σ phi·counts`` over
  each chunk's token slots with ``counts > 0``, and the per-slice sums
  (``wz``, the Elogtheta sums, the document counts) as one row a document
  over its slice id.  No float atomics, so a step is deterministic.
* The betahat update is the Polak–Ribière CG with back-tracking
  (DTM.jl:286-301) on Σ_t Elogpw + Elogpbeta, whose gradient
  ``torch.autograd`` takes through the smoother (the JAX package's
  ``jax.grad``); its loop stops once CG has converged, where the JAX
  scan runs on with zero steps.
* The per-slice alpha Newtons are one batched Newton
  (``ops/newton.dirichlet_newton_batched``).
* The E-step fixpoint has no kernel (the JAX package has none either).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from ..kernels.scatter_rows import build_plan
from ..ops.newton import dirichlet_newton_batched
from ..ops.segment import count_scatter_into
from ..parallel.mesh import axis_tuple
from ..parallel.shard import all_gather, pmax, psum, psum_scatter
from ..utils.numerics import (
    EPSILON, categorical_entropy, digamma, dirichlet_entropy, finite, kbn_add, kbn_pack,
    kbn_psum, kbn_zero, kbn_zeros, l2norm, lgamma, masked_fixpoint,
)


@dataclasses.dataclass
class DTMState:
    alpha: torch.Tensor       # [T, K]  per-slice Dirichlet hyperparameter
    betahat: torch.Tensor     # [T, K, V] variational pseudo-observations
    mbeta: torch.Tensor       # [T, K, V] smoothed means
    vbeta: torch.Tensor       # [T, K, V] smoothed variances (betahat-free)
    v_filt: torch.Tensor      # [T, K, V] filtered variances (for the smoother)
    gamma: torch.Tensor       # [M_pad, K]
    Elogtheta: torch.Tensor   # [M_pad, K]
    lzeta: torch.Tensor       # [M_pad] per-document softmax bound variable
    elbo: torch.Tensor        # compensated (hi, lo) bound, shape (2,)


# fixed hyperparameters (DTM.jl:98-103)
SIGMASQ = 1.0   # state-transition variance
BSQ = 1.0       # pseudo-observation variance
V0 = 1.0        # prior variance
M0 = 0.0        # prior mean


def variance_smoother(T: int, K: int, V: int, dtype=torch.float32, device="cpu"):
    """Filtered and smoothed variances (updateVbeta!, DTM.jl:231-242),
    independent of betahat: computed once.  Returns (v_filt, vbeta)."""
    v_prev = torch.full((K, V), V0, dtype=dtype, device=device)
    filt = []
    for _ in range(T):
        v_prev = (BSQ / (v_prev + SIGMASQ + BSQ)) * (v_prev + SIGMASQ) + EPSILON
        filt.append(v_prev)
    smooth = [filt[-1]]
    for v_t in reversed(filt[:-1]):
        smooth.append(v_t + (v_t / (v_t + SIGMASQ)) ** 2 * (smooth[-1] - v_t - SIGMASQ)
                      + EPSILON)
    return torch.stack(filt), torch.stack(smooth[::-1])


def mean_smoother(betahat: torch.Tensor, v_filt: torch.Tensor) -> torch.Tensor:
    """Smoothed means mbeta(betahat) (updateMbeta!, DTM.jl:209-223):
    forward filter m_t = q·m_{t−1} + (1−q)·betahat_t with q =
    bsq/(v_{t−1}+σ²+bsq), then backward smoothing.  Differentiable: the
    CG gradient flows through both loops."""
    T = betahat.shape[0]
    m_prev = torch.full_like(betahat[0], M0)
    v_pm = torch.full_like(v_filt[0], V0)
    m = []
    for t in range(T):
        q = BSQ / (v_pm + SIGMASQ + BSQ)
        m_prev = q * m_prev + (1.0 - q) * betahat[t]
        m.append(m_prev)
        v_pm = v_filt[t]
    mb = [m[-1]]
    for t in range(T - 2, -1, -1):
        q = SIGMASQ / (v_filt[t] + SIGMASQ)
        mb.append(q * m[t] + (1.0 - q) * mb[-1])
    return torch.stack(mb[::-1])


def init(generator: torch.Generator, packed, K: int, T: int, dtype=torch.float32,
         device="cpu", betahat0: Optional[np.ndarray] = None,
         alpha0: Optional[np.ndarray] = None,
         gamma0: Optional[np.ndarray] = None) -> DTMState:
    """Constructor state (DTM.jl:89-118), with optional warm-start arrays.
    betahat is drawn on ``generator``'s device and moved to ``device``."""
    M_pad, V = packed.M_pad, packed.V
    put = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype).to(device)
    if betahat0 is None:
        betahat = torch.randn((T, K, V), generator=generator, dtype=dtype).to(device)
    else:
        betahat = put(betahat0)
    alpha = (torch.ones((T, K), dtype=dtype, device=device) if alpha0 is None
             else put(alpha0))
    gamma = (torch.ones((M_pad, K), dtype=dtype, device=device) if gamma0 is None
             else put(gamma0))
    v_filt, vbeta = variance_smoother(T, K, V, dtype, device)
    El = digamma(gamma) - digamma(torch.sum(gamma, -1, keepdim=True))
    return DTMState(alpha=alpha, betahat=betahat, mbeta=mean_smoother(betahat, v_filt),
                    vbeta=vbeta, v_filt=v_filt, gamma=gamma, Elogtheta=El,
                    lzeta=torch.ones((M_pad,), dtype=dtype, device=device),
                    elbo=torch.zeros((2,), dtype=dtype, device=device))


def _phi(mbeta_d, decay, El):
    """phi ∝ softmax_K(mbeta[t][:, terms] − decay_k + Elogtheta)
    (updatePhi!, DTM.jl:204-207); decay = e^{maxl−lzeta}·Σ_v e^{x−maxl}."""
    return torch.softmax(mbeta_d - decay[:, None, :] + El[:, None, :], dim=-1)


def _overflow_safe(state: DTMState, mesh=None, vocab_axis=None):
    """(maxl [T], rowsum [T, K]): overflow-safe pieces of
    Σ_v exp(mbeta + vbeta/2) (DTM.jl:225-228), and mbeta as [T·V, K]
    (slice-major) so that one gather serves every document's slice.
    With ``vocab_axis`` (the state's [T, K, V/n] blocks) the max and the
    sums span the whole vocabulary (a ``pmax`` and a ``psum``) and mbeta
    is gathered whole."""
    x = state.mbeta + 0.5 * state.vbeta
    maxl = pmax(torch.amax(x, dim=(1, 2)), mesh, vocab_axis)
    rowsum = psum(torch.sum(torch.exp(x - maxl[:, None, None]), dim=2), mesh, vocab_axis)
    mbeta = state.mbeta
    if vocab_axis is not None:
        mbeta = all_gather(mbeta, mesh, vocab_axis, dim=2)
    T, K, V = mbeta.shape
    mbeta_flat = mbeta.permute(0, 2, 1).reshape(T * V, K).contiguous()
    return maxl, rowsum, mbeta_flat


def _estep_chunk(mbeta_flat, alpha, rowsum_ovfl, maxl, slice_id, flat_idx, counts,
                 doc_mask, gamma, El, lzeta, viter, vtol):
    """Per-chunk E-step fixpoint (train! inner loop, DTM.jl:317-328).

    slice_id [B] (int64), flat_idx = slice_id·V + terms [B, L] (int64).
    Returns the new (gamma, El, lzeta), the token rows ``w = phi·counts``
    [B, L, K] of the final phi and their per-document sums ``pc`` [B, K]."""
    mbeta_d = mbeta_flat[flat_idx]                   # [B, L, K]
    rs_d = rowsum_ovfl[slice_id]                     # [B, K]
    maxl_d = maxl[slice_id]                          # [B]
    alpha_d = alpha[slice_id]                        # [B, K]

    def body(_, carry):
        gamma, El, lzeta, active = carry
        decay = torch.exp(maxl_d - lzeta)[:, None] * rs_d
        pc = torch.einsum("bl,blk->bk", counts, _phi(mbeta_d, decay, El))
        gamma_new = alpha_d + pc + EPSILON                          # updateGamma! (DTM.jl:199-202)
        El_new = digamma(gamma_new) - digamma(torch.sum(gamma_new, -1, keepdim=True))
        lzeta_new = maxl_d + torch.log(torch.sum(pc * rs_d, -1) + EPSILON)   # DTM.jl:306-309
        upd = active[:, None]
        gamma2 = torch.where(upd, gamma_new, gamma)
        El2 = torch.where(upd, El_new, El)
        lzeta2 = torch.where(active, lzeta_new, lzeta)
        # break: ‖Δgamma‖ < vtol (DTM.jl:324)
        return gamma2, El2, lzeta2, active & (l2norm(gamma2 - gamma) >= vtol)

    gamma, El, lzeta, _ = masked_fixpoint(body, (gamma, El, lzeta, doc_mask > 0), viter)
    # sufficient statistics with the final phi
    decay = torch.exp(maxl_d - lzeta)[:, None] * rs_d
    w = _phi(mbeta_d, decay, El) * counts[..., None]
    return gamma, El, lzeta, w, torch.sum(w, dim=1)


def cg_objective(betahat, v_filt, vbeta, A, wz):
    """Σ_t Elogpw + Elogpbeta as a function of betahat (calcstep,
    DTM.jl:254), with phi and lzeta frozen in the statistics A [T·V, K]
    and wz [T, K]."""
    T, K, V = betahat.shape
    mbeta = mean_smoother(betahat, v_filt)
    # Elogpw linear and exp terms (DTM.jl:139-143), constants dropped
    lin = torch.sum(A.reshape(T, V, K) * mbeta.permute(0, 2, 1))
    rowsum = torch.sum(torch.exp(mbeta + 0.5 * vbeta), dim=2)    # [T, K]
    expterm = torch.sum(wz * rowsum)
    # Elogpbeta (DTM.jl:119-126), vbeta terms constant and dropped; t = 1
    # anchors on the smoothed time-0 mean q·m0 + (1−q)·mbeta[1], q =
    # σ²/(v0+σ²) (updateMbeta!, DTM.jl:222-223)
    q0 = SIGMASQ / (V0 + SIGMASQ)
    mbeta0 = q0 * M0 + (1.0 - q0) * mbeta[:1]
    prev = torch.cat([mbeta0, mbeta[:-1]], 0)
    pbeta = -(0.5 / SIGMASQ) * torch.sum((mbeta - prev) ** 2)
    return lin - expterm + pbeta


def make_global_update(niter: int, ntol: float, cgiter: int, cgtol: float, mesh=None,
                       vocab_axis=None):
    """The DTM M-step as a function of the accumulated statistics: the
    per-slice alpha Newtons (updateAlpha!, DTM.jl:176-197) and the betahat
    Polak–Ribière CG with back-tracking (updateBetahat!, DTM.jl:244-304).

    Returns ``update(alpha, betahat, v_filt, vbeta, A, wz, els_hi, els_lo,
    nd) -> (alpha_new, betahat_new, mbeta_new)``.  Each CG iteration reads
    the line search's test back to the host once a trial step, and the
    stop flag once.  With ``vocab_axis`` the [T, K, V] tensors (and A's
    rows) are this process's vocab block: the smoother runs on it alone
    (it is elementwise over V), and the objective and every inner product
    of the CG are summed over the axis outside the differentiated
    function, so every process takes the same steps."""
    gsum = lambda x: psum(x, mesh, vocab_axis)

    def value_and_grad(bh, obj):
        with torch.enable_grad():
            x = bh.detach().requires_grad_(True)
            f = obj(x)
            g, = torch.autograd.grad(f, x)
        return f.detach(), g

    @torch.no_grad()
    def update(alpha, betahat, v_filt, vbeta, A, wz, els_hi, els_lo, nd):
        alpha_new = dirichlet_newton_batched(alpha, els_hi, torch.clamp(nd, min=1.0), niter,
                                             ntol, Elogtheta_sum_lo=els_lo)
        obj_local = lambda b: cg_objective(b, v_filt, vbeta, A, wz)
        obj = lambda b: gsum(obj_local(b))
        dt, dev = betahat.dtype, betahat.device
        bh, p_dir, g_old = betahat, torch.zeros_like(betahat), torch.ones_like(betahat)
        rho = torch.tensor(1.0, dtype=dt, device=dev)
        f0 = torch.tensor(float("inf"), dtype=dt, device=dev)
        done = torch.tensor(False, device=dev)
        for _ in range(cgiter):
            f0_new, g = value_and_grad(bh, obj_local)
            f0_new = gsum(f0_new)
            f0 = torch.where(torch.isfinite(f0), f0, f0_new)   # the first iteration
            denom = gsum(torch.sum(g_old * g_old))
            pr = torch.clamp(gsum(torch.sum(g * (g - g_old))) / torch.clamp(denom, min=1e-30),
                             0.0, 1.0)
            p_dir = g + pr * p_dir                               # ascent direction
            slope = gsum(torch.sum(g * p_dir))
            # a momentum-dominated direction can stop ascending: restart
            # from steepest ascent (the standard NCG safeguard)
            bad_dir = slope <= 0.0
            p_dir = torch.where(bad_dir, g, p_dir)
            slope = torch.where(bad_dir, gsum(torch.sum(g * g)), slope)
            r = rho
            f = obj(bh + r * p_dir)
            it = 0
            while it < 10 and bool(f <= f0 + 1e-4 * r * slope):
                r = r * 0.5
                f = obj(bh + r * p_dir)
                it += 1
            # reject the step when back-tracking ran out without the
            # sufficient-increase condition (keeps CAVI monotone)
            ok = f > f0 + 1e-4 * r * slope
            take = ok & ~done
            bh = bh + torch.where(take, r, 0.0) * p_dir
            f_acc = torch.where(take, f, f0)
            # converged once an accepted step improves the objective by
            # less than cgtol; a rejected step retries from a smaller rho
            # with a fresh gradient (the reference's persistent rho,
            # DTM.jl:291-301)
            done = done | (ok & (f_acc - f0 < cgtol))
            g_old, rho, f0 = g, torch.clamp(r * 2.0, max=1.0), f_acc
            if bool(done):
                break   # the JAX scan's remaining iterations take zero steps
        return alpha_new, bh, mean_smoother(bh, v_filt)

    return update


def _chunk_rows(packed, chunk_docs: int) -> list:
    M_pad = packed.M_pad
    B = min(chunk_docs, M_pad)
    if M_pad % B:
        raise ValueError(f"packed doc axis {M_pad} does not divide into chunks of {B}")
    return [slice(lo, lo + B) for lo in range(0, M_pad, B)]


def scatter_plans(packed, slice_id: np.ndarray, chunk_docs: int, device) -> list:
    """Per chunk, the two scatter plans of the M-step statistics, built
    from the host arrays and put on ``device``: the token slots with
    ``counts > 0`` by ``slice_id·V + term`` (rows of A [T·V, K]), and the
    documents with ``doc_mask > 0`` by slice id (rows of [T, 2K+1])."""
    V = packed.V
    out = []
    for rows in _chunk_rows(packed, chunk_docs):
        sid = slice_id[rows].astype(np.int64)
        flat = sid[:, None] * V + packed.terms[rows]
        out.append((build_plan(flat, packed.counts[rows] > 0).to(device),
                    build_plan(sid, packed.doc_mask[rows] > 0).to(device)))
    return out


def sweep_chunk(prep, alpha, sid, terms, counts, doc_mask, gamma, El, lzeta, tplan, splan, A,
                viter: int, vtol: float) -> tuple:
    """One chunk of the E-step sweep, on any [B, L] chunk with its slice
    ids ``sid`` [B] (int64); ``prep`` is :func:`_overflow_safe`'s (maxl,
    rowsum, mbeta_flat).  A[t·V + v, k] += Σ phi·counts (the per-slice
    Elogpw linear term) along ``tplan``, in place.  Returns the chunk's new
    (gamma, El, lzeta) and its per-slice sums [T, 2K+1] along ``splan``:
    wz = Σ e^{−lzeta}·(phi@counts), the Elogtheta sums and the document
    counts (the alpha Newtons' inputs)."""
    maxl, rowsum, mbeta_flat = prep
    T, K = rowsum.shape
    flat = sid[:, None] * (mbeta_flat.shape[0] // T) + terms
    g2, el2, lz2, w, pc = _estep_chunk(mbeta_flat, alpha, rowsum, maxl, sid, flat, counts,
                                       doc_mask, gamma, El, lzeta, viter, vtol)
    count_scatter_into(A, w.reshape(-1, K), tplan)
    dm = doc_mask[:, None]
    per_doc = torch.cat([torch.exp(-lz2)[:, None] * pc * dm, el2 * dm, dm], dim=1)
    s = count_scatter_into(torch.zeros((T, 2 * K + 1), dtype=A.dtype, device=A.device),
                           per_doc, splan)
    return g2, el2, lz2, s


def make_sweep(packed, K: int, T: int, viter: int, vtol: float, chunk_docs: int,
               slice_id: np.ndarray, device, mesh=None, axis_name=None, vocab_axis=None):
    """The E-step sweep over every chunk:
    ``sweep(state, slice_id, terms, counts, doc_mask) -> (gamma, El,
    lzeta, A, wz, els, nd)``, ``els`` a compensated (hi, lo) pair.  With a
    ``mesh`` (``packed`` and ``slice_id`` this process's rows), wz, els,
    nd and A are summed over ``axis_name`` at the end.  With
    ``vocab_axis`` the state's [T, K, V] tensors are this process's
    [T, K, V/n] blocks: mbeta is gathered whole, the plans scatter into
    the whole [T·V, K] statistic, and the sum over ``vocab_axis`` keeps
    this process's [T·V/n, K] rows of it (``psum_scatter``)."""
    rest = tuple(a for a in axis_tuple(axis_name) if a != vocab_axis)
    V = packed.V
    chunks = _chunk_rows(packed, chunk_docs)
    plans = scatter_plans(packed, slice_id, chunk_docs, device)

    def sweep(state: DTMState, slice_id, terms, counts, doc_mask):
        dt, dev = state.betahat.dtype, state.betahat.device
        maxl, rowsum, mbeta_flat = _overflow_safe(state, mesh, vocab_axis)
        A = torch.zeros((T * V, K), dtype=dt, device=dev)
        wz = torch.zeros((T, K), dtype=dt, device=dev)
        nd = torch.zeros((T,), dtype=dt, device=dev)
        # the per-slice Elogtheta sums ride a compensated carry, as the
        # Elogtheta sum of models/lda.py does
        els = kbn_zeros((T, K), dt, dev)
        gamma = torch.empty_like(state.gamma)
        El = torch.empty_like(state.Elogtheta)
        lzeta = torch.empty_like(state.lzeta)
        for rows, (tplan, splan) in zip(chunks, plans):
            g2, el2, lz2, s = sweep_chunk(
                (maxl, rowsum, mbeta_flat), state.alpha, slice_id[rows], terms[rows],
                counts[rows], doc_mask[rows], state.gamma[rows], state.Elogtheta[rows],
                state.lzeta[rows], tplan, splan, A, viter, vtol)
            wz = wz + s[:, :K]
            els = kbn_add(els, s[:, K:2 * K])
            nd = nd + s[:, 2 * K]
            gamma[rows], El[rows], lzeta[rows] = g2, el2, lz2
        wz = psum(wz, mesh, axis_name)
        els = kbn_psum(els, mesh, axis_name)
        nd = psum(nd, mesh, axis_name)
        if vocab_axis is not None:
            A = psum(psum_scatter(A.reshape(T, V, K), mesh, vocab_axis, dim=1), mesh, rest)
            A = A.reshape(-1, K)
        else:
            A = psum(A, mesh, axis_name)
        return gamma, El, lzeta, A, wz, els, nd

    return sweep


def make_step(packed, K: int, T: int, viter: int, vtol: float, niter: int, ntol: float,
              cgiter: int, cgtol: float, chunk_docs: int, slice_id: np.ndarray, device,
              mesh=None, axis_name=None, vocab_axis=None):
    """One full CAVI sweep (train!, DTM.jl:311-335): the per-document
    fixpoints, the per-slice alpha Newtons, then the betahat CG.

    ``step(state, slice_id, terms, counts, doc_mask)`` takes the dense
    packed tensors on ``device`` (``slice_id`` int64 [M_pad], the host copy
    of which builds the scatter plans here).  ``step.sweep`` and
    ``step.update`` are its two halves; ``mesh`` and ``vocab_axis``: as in
    :func:`make_sweep` and :func:`make_global_update` (the update then runs
    alike on every process)."""
    sweep = make_sweep(packed, K, T, viter, vtol, chunk_docs, slice_id, device,
                       mesh=mesh, axis_name=axis_name, vocab_axis=vocab_axis)
    update = make_global_update(niter, ntol, cgiter, cgtol, mesh=mesh, vocab_axis=vocab_axis)

    def step(state: DTMState, slice_id, terms, counts, doc_mask) -> DTMState:
        gamma, El, lzeta, A, wz, els, nd = sweep(state, slice_id, terms, counts, doc_mask)
        alpha_new, betahat_new, mbeta_new = update(
            state.alpha, state.betahat, state.v_filt, state.vbeta, A, wz, els[0], els[1], nd)
        return DTMState(alpha=alpha_new, betahat=betahat_new, mbeta=mbeta_new,
                        vbeta=state.vbeta, v_filt=state.v_filt, gamma=gamma, Elogtheta=El,
                        lzeta=lzeta, elbo=state.elbo)

    step.sweep, step.update = sweep, update
    return step


def slice_elbo_terms(state: DTMState) -> torch.Tensor:
    """The document-independent bound terms Elogpbeta − Elogqbeta
    (DTM.jl:119-126, 145-148); t = 1 anchors on the smoothed time-0
    posterior (updateMbeta!/updateVbeta!, DTM.jl:222-223, 241)."""
    T, K, V = state.mbeta.shape
    q0 = SIGMASQ / (V0 + SIGMASQ)
    mbeta0 = q0 * M0 + (1.0 - q0) * state.mbeta[:1]
    vbeta0 = V0 + (V0 / (V0 + SIGMASQ)) ** 2 * (state.vbeta[:1] - V0 - SIGMASQ)
    prev_m = torch.cat([mbeta0, state.mbeta[:-1]], 0)
    prev_v = torch.cat([vbeta0, state.vbeta[:-1]], 0)
    e_pb = (-0.5 * T * K * V * math.log(2 * math.pi * SIGMASQ)
            - (0.5 / SIGMASQ) * torch.sum((state.mbeta - prev_m) ** 2 + state.vbeta + prev_v))
    # + the entropy of N(mbeta, vbeta) per coordinate
    e_qb = 0.5 * torch.sum(torch.log(2 * math.pi * math.e * state.vbeta))
    return e_pb + e_qb


def make_elbo(packed, K: int, T: int, chunk_docs: int, mesh=None, axis_name=None,
              vocab_axis=None):
    """The full ELBO (updateELBO!, DTM.jl:161-174), as a compensated
    (hi, lo) pair; with a ``mesh`` the document terms are reduced over
    ``axis_name`` before the slice terms are added.  ``vocab_axis``
    gathers mbeta and vbeta whole first."""
    chunks = _chunk_rows(packed, chunk_docs)

    def elbo(state: DTMState, slice_id, terms, counts, doc_mask) -> torch.Tensor:
        dt, dev = state.betahat.dtype, state.betahat.device
        if vocab_axis is not None:
            state = dataclasses.replace(state, **{
                f: all_gather(getattr(state, f), mesh, vocab_axis, dim=2)
                for f in ("mbeta", "vbeta")})
        maxl, rowsum, mbeta_flat = _overflow_safe(state)
        total = kbn_zero(dt, dev)
        for rows in chunks:
            total = kbn_add(total, elbo_chunk(
                (maxl, rowsum, mbeta_flat), state.alpha, slice_id[rows], terms[rows],
                counts[rows], doc_mask[rows], state.gamma[rows], state.Elogtheta[rows],
                state.lzeta[rows]))
        total = kbn_psum(total, mesh, axis_name)
        return kbn_pack(kbn_add(total, slice_elbo_terms(state)))

    return elbo


def elbo_chunk(prep, a, sid, terms, c, dm, g, el, lz) -> torch.Tensor:
    """One chunk's document and token bound terms, on any [B, L] chunk,
    summed over its real documents; ``prep`` as in :func:`sweep_chunk`."""
    maxl, rowsum, mbeta_flat = prep
    T = rowsum.shape[0]
    mbeta_d = mbeta_flat[sid[:, None] * (mbeta_flat.shape[0] // T) + terms]
    rs_d, e_ml = rowsum[sid], torch.exp(maxl[sid] - lz)
    p = _phi(mbeta_d, e_ml[:, None] * rs_d, el)
    a_d = a[sid]
    # Elogptheta (DTM.jl:128-131)
    e_pt = (finite(lgamma(torch.sum(a_d, -1))) - torch.sum(finite(lgamma(a_d)), -1)
            + torch.sum((a_d - 1.0) * el, -1))
    pc = torch.einsum("bl,blk->bk", c, p)
    e_pz = torch.sum(pc * el, -1)                              # Elogpz (DTM.jl:133-137)
    e_pw = (torch.sum(p * mbeta_d * c[..., None], dim=(1, 2))  # Elogpw (DTM.jl:139-143)
            - torch.sum(pc * rs_d, -1) * e_ml - lz + 1.0)
    # −Elogqtheta, −Elogqz (DTM.jl:150-159)
    e_qt = dirichlet_entropy(g)
    e_qz = torch.sum(categorical_entropy(p) * c, dim=-1)
    return torch.sum(dm * (e_pt + e_pz + e_pw + e_qt + e_qz))


def topics_ranking_by_slice(mbeta: torch.Tensor) -> np.ndarray:
    """Top-terms permutation per (slice, topic) (DTM.jl:336), 1-based."""
    return np.argsort(-mbeta.detach().cpu().numpy(), axis=2, kind="stable") + 1
