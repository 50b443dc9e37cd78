"""Newton solvers, run on the device that holds their state.

* :func:`dirichlet_newton_batched` — the Dirichlet hyperparameter update
  (reference LDA.jl:97-118): interior-point Newton with a log barrier and
  back-tracking, for S independent Dirichlets at once (DTM's per-slice
  alpha, DTM.jl:176-197), one stop mask a row and one host read an
  iteration for all of them; :func:`dirichlet_newton` is its one-row
  case, LDA's and fLDA's alpha.
* :func:`ctm_lambda_newton` — the CTM per-document Newton (CTM.jl:129-142)
  batched over a chunk of documents, its K×K SPD solve done matrix-free
  by the Jacobi-preconditioned CG of :func:`spd_cg_solve`, as in the JAX
  package, instead of the reference's in-kernel Gauss–Jordan.
* :func:`ctm_vsq_newton` — the per-coordinate vsq Newton with
  back-tracking (CTM.jl:146-165), elementwise over [B, K].

The JAX package's ``lax.while_loop``s become Python loops through
``masked_fixpoint``; the CTM loops test their ``active`` mask on the host
every ``CHECK_EVERY`` iterations only (bit-identical to every iteration).
"""

from __future__ import annotations

import torch

from ..utils.numerics import EPSILON, digamma, finite, l2norm, masked_fixpoint, trigamma

# iterations of the CTM Newtons and of CG queued between two host reads
# of their ``active`` mask
CHECK_EVERY = 4


def _exp_safe(x: torch.Tensor) -> torch.Tensor:
    """exp with its exponent clamped at 60 (f32) or 600 (f64), the CTM
    Newtons' guard against the reference's large-mu overflow (its own
    todo.txt:8/11): identical in any sane regime, finite above it, so the
    Hessian stays SPD and the Newton contracts lambda back."""
    hi = 60.0 if x.dtype == torch.float32 else 600.0
    return torch.exp(torch.clamp(x, max=hi))


def _backtrack_rho(x: torch.Tensor, p: torch.Tensor, strict: bool) -> torch.Tensor:
    """Largest ρ = 2^-m with x − ρ·p > 0 (strict) or ≥ 0, elementwise: the
    closed form of the reference's halving loop ``while x - rho*p <= 0:
    rho *= 0.5`` (CTM.jl:154-156)."""
    pos = p > 0
    ratio = torch.where(pos, x / torch.where(pos, p, torch.ones_like(p)),
                        torch.full_like(p, float("inf")))
    m = torch.clamp(torch.ceil(-torch.log2(torch.clamp(ratio, max=1.0))), min=0.0)
    rho = torch.exp2(-m)
    if strict:  # x − ρ·p must stay strictly positive: halve exact ties
        rho = torch.where(x - rho * p <= 0, rho * 0.5, rho)
    return torch.where(torch.isfinite(ratio), rho, torch.ones_like(rho))


def _cg_iter(invsigma, expo, inv_diag, tol2, x, r, p, rz, act):
    """One CG iteration on the operator Σ⁻¹ + diag(expo), row-wise over [B, K]."""
    Ap = p @ invsigma + expo * p
    pAp = torch.sum(p * Ap, dim=-1)
    alpha = torch.where(act, rz / torch.where(pAp > 0, pAp, 1.0), 0.0)
    x = x + alpha[:, None] * p
    r = r - alpha[:, None] * Ap
    z = r * inv_diag
    rz_new = torch.sum(r * z, dim=-1)
    beta = rz_new / torch.where(rz > 0, rz, 1.0)
    p = torch.where(act[:, None], z + beta[:, None] * p, p)
    return x, r, p, rz_new, act & (torch.sum(r * r, dim=-1) > tol2)


class _CGBlock:
    """``n`` CG iterations captured once as a CUDA graph over static
    buffers: the operator, the preconditioner, the tolerance and the carry
    (x, r, p, rz, act), which each replay advances in place."""

    def __init__(self, B: int, K: int, dtype, device, n: int):
        z = lambda *shape: torch.zeros(shape, dtype=dtype, device=device)
        self.const = (z(K, K), z(B, K), z(B, K), z(B))           # invsigma, expo, inv_diag, tol2
        self.carry = (z(B, K), z(B, K), z(B, K), z(B),
                      torch.zeros((B,), dtype=torch.bool, device=device))
        self.n = n
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            self._run()                                          # warm-up before capture
        torch.cuda.current_stream(device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self._run()

    def _run(self):
        c = self.carry
        for _ in range(self.n):
            c = _cg_iter(*self.const, *c)
        for dst, src in zip(self.carry, c):
            dst.copy_(src)


_CG_BLOCKS = {}   # (B, K, dtype, device, n) -> _CGBlock, built at first use


def _cg_eager(const, carry, maxiter: int, check_every: int) -> torch.Tensor:
    """The CG loop one iteration at a time, its mask tested every
    ``check_every`` iterations."""
    x, *_ = masked_fixpoint(lambda _, c: _cg_iter(*const, *c), carry, maxiter, check_every)
    return x


def _cg_graphed(const, carry, maxiter: int, check_every: int) -> torch.Tensor:
    """The same loop with each run of ``check_every`` iterations one replay
    of a CUDA graph, and the last ``maxiter mod check_every`` eager."""
    key = (*carry[0].shape, carry[0].dtype, carry[0].device, check_every)
    if key not in _CG_BLOCKS:
        _CG_BLOCKS[key] = _CGBlock(*key)
    g = _CG_BLOCKS[key]
    for dst, src in zip(g.const + g.carry, const + carry):
        dst.copy_(src)
    i = 0
    while i < maxiter and bool(torch.any(g.carry[-1])):
        if maxiter - i >= check_every:
            g.graph.replay()
            i += check_every
        else:
            c = g.carry
            for _ in range(maxiter - i):
                c = _cg_iter(*g.const, *c)
            for dst, src in zip(g.carry, c):
                dst.copy_(src)
            i = maxiter
    return g.carry[0].clone()


def spd_cg_solve(invsigma: torch.Tensor, expo: torch.Tensor, b: torch.Tensor,
                 inv_diag: torch.Tensor, active: torch.Tensor, maxiter: int, rtol: float,
                 check_every: int = CHECK_EVERY) -> torch.Tensor:
    """Matrix-free batched Jacobi-preconditioned CG for the SPD systems
    (Σ⁻¹ + diag(expo)) x = b of the CTM lambda Newton (the JAX package's
    ``ops/newton.py:spd_cg_solve`` with that operator).

    invsigma: [K, K]; expo, b, inv_diag: [B, K]; active: [B] bool.  The
    [B, K, K] operator never exists.  Lanes that are inactive or have
    converged are frozen, their ``p`` kept finite so that no 0·inf
    appears.  On CUDA tensors each run of ``check_every`` iterations
    between two tests of the mask is one replay of a CUDA graph (cached
    per shape), not ~25 launches each: the loop is bound by the host's
    launches otherwise.  The result is the same as the eager loop's."""
    bnorm2 = torch.sum(b * b, dim=-1)
    const = (invsigma, expo, inv_diag, (rtol * rtol) * bnorm2)
    carry = (torch.zeros_like(b), b, b * inv_diag, torch.sum(b * (b * inv_diag), dim=-1),
             active & (bnorm2 > 0))
    solve = _cg_graphed if b.device.type == "cuda" else _cg_eager
    return solve(const, carry, maxiter, check_every)


def dirichlet_newton(
    alpha: torch.Tensor,
    Elogtheta_sum: torch.Tensor,
    M: float,
    niter: int,
    ntol: float,
    Elogtheta_sum_lo: torch.Tensor = None,
) -> torch.Tensor:
    """Interior-point Newton for one Dirichlet parameter [K]
    (LDA.jl:97-118): :func:`dirichlet_newton_batched` on one row."""
    M = torch.as_tensor(M, dtype=alpha.dtype, device=alpha.device).reshape(1)
    lo = None if Elogtheta_sum_lo is None else Elogtheta_sum_lo[None]
    return dirichlet_newton_batched(alpha[None], Elogtheta_sum[None], M, niter, ntol, lo)[0]


def dirichlet_newton_batched(
    alpha: torch.Tensor,
    Elogtheta_sum: torch.Tensor,
    M: torch.Tensor,
    niter: int,
    ntol: float,
    Elogtheta_sum_lo: torch.Tensor = None,
) -> torch.Tensor:
    """Interior-point Newton for the Dirichlet parameter (LDA.jl:97-118)
    on each row of ``alpha`` [S, K] at once, with its row of
    ``Elogtheta_sum`` [S, K] (and ``_lo``) and its count ``M`` [S]: the
    JAX package's ``jax.vmap(dirichlet_newton)`` over DTM's slices.

    The gradient is evaluated in MEAN form — ``M·(nu/(M·alpha) + ψ(Σa)
    − ψ(a_k) + Elogtheta_sum/M)`` — so the near-cancellation at the
    optimum resolves at the ulp of O(1) quantities instead of
    O(M·|Elogtheta|).  ``Elogtheta_sum_lo`` carries the compensation
    half of a Kahan-accumulated sum (models/lda.py's step carry) into
    the mean at full precision.

    A row that has stopped is frozen, so every row follows the iterations
    it would run alone; the loop ends when all rows have stopped, read
    back once an iteration.  Every row still running has run from the
    first iteration, so the barrier weight ``nu`` is one number for all
    of them."""
    K = alpha.shape[-1]
    dtype = alpha.dtype
    M = torch.as_tensor(M, dtype=dtype, device=alpha.device)[:, None]     # [S, 1]
    nu = float(K)
    el_mean = Elogtheta_sum / M
    if Elogtheta_sum_lo is not None:
        el_mean = el_mean + Elogtheta_sum_lo / M

    prev_norm = torch.full(alpha.shape[:1], float("inf"), dtype=dtype, device=alpha.device)
    done = torch.zeros(alpha.shape[:1], dtype=torch.bool, device=alpha.device)
    for i in range(niter):
        a0 = torch.sum(alpha, dim=-1, keepdim=True)
        grad = M * (nu / (M * alpha) + digamma(a0) - digamma(alpha) + el_mean)
        h_inv = -1.0 / (M * trigamma(alpha) + nu / alpha**2)
        denom = 1.0 / (M * trigamma(a0)) + torch.sum(h_inv, dim=-1, keepdim=True)
        p = (grad - torch.sum(grad * h_inv, dim=-1, keepdim=True) / denom) * h_inv
        # back-tracking: minimum(alpha - rho*p) must stay >= 0
        # (LDA.jl:107-109).  The reference halves rho from 1; the final
        # value is the largest 2^-m with rho <= min_k alpha_k/p_k over
        # descending coordinates, computed here in closed form.
        pos = p > 0
        ratio = torch.where(pos, alpha / torch.where(pos, p, torch.ones_like(p)),
                            torch.full_like(p, float("inf")))
        r_star = torch.amin(ratio, dim=-1, keepdim=True)
        m = torch.clamp(torch.ceil(-torch.log2(torch.clamp(r_star, max=1.0))), min=0.0)
        rho = torch.exp2(-m)
        # division can round alpha/p up across the power-of-two boundary;
        # validate the actual step like the reference's while-condition
        rho = torch.where(torch.amin(alpha - rho * p, dim=-1, keepdim=True) < 0, rho * 0.5, rho)
        alpha_new = finite(alpha - rho * p)
        # reference stopping rule (LDA.jl:113-115) — plus, on f32 only,
        # two numerical stops: a step below f32 resolution of alpha makes
        # no progress, and once the barrier has annealed away a step that
        # stops contracting is a limit cycle.  f64 keeps the reference's
        # own rule alone.
        sn = rho[:, 0] * l2norm(p)
        annealed = nu / K < ntol
        stop = (rho[:, 0] * l2norm(grad) < ntol) & annealed
        if dtype == torch.float32:
            stagnant = sn <= 1e-6 * (l2norm(alpha) + 1.0)
            cycling = (sn >= prev_norm) & (annealed and i >= 20)
            stop = stop | stagnant | cycling
        alpha = torch.where(done[:, None], alpha, alpha_new)
        done = done | stop
        nu *= 0.5
        prev_norm = sn
        if bool(torch.all(done)):
            break
    # @positive model.alpha (LDA.jl:117)
    return alpha + EPSILON


def ctm_lambda_newton(lam, vsq, logzeta, phi_counts, C, mu, invsigma, active,
                      niter: int, ntol: float, check_every: int = CHECK_EVERY):
    """Batched CTM lambda Newton (CTM.jl:129-142).

    lam, vsq, phi_counts (= phi·counts): [B, K]; logzeta, C (token totals):
    [B]; mu: [K]; invsigma: [K, K]; active: [B] bool.  Per iteration
    grad = Σ⁻¹(μ−λ) + φc − C·exp(λ + v²/2 − logζ) and λ += (Σ⁻¹ + diag(C·
    exp(·)))⁻¹ grad by CG.  A document stops at ‖grad‖ < ntol (the
    reference's rule), or once its step is below 1e-5 of ‖λ‖ or, after 8
    iterations, stops contracting: at f32 the C-scaled gradient's noise
    can stay above ntol forever.
    """
    K = lam.shape[-1]
    isd = torch.diagonal(invsigma)
    # CG only needs a few digits for an inexact Newton step; f64 runs it
    # to machine precision, as the reference's exact solve (CTM.jl:139)
    cg_rtol = 1e-5 if lam.dtype == torch.float32 else 1e-13

    def body(i, carry):
        lam, prev_norm, act = carry
        expo = _exp_safe(lam + 0.5 * vsq - logzeta[:, None]) * C[:, None]
        grad = (mu - lam) @ invsigma + phi_counts - expo
        step = spd_cg_solve(invsigma, expo, grad, 1.0 / (isd[None, :] + expo), act, K + 8,
                            cg_rtol, check_every)
        lam_new = torch.where(act[:, None], lam + step, lam)
        sn = l2norm(step)
        stagnant = sn <= 1e-5 * (l2norm(lam_new) + 1.0)
        cycling = (sn >= prev_norm) & (i >= 8)
        return lam_new, sn, act & (l2norm(grad) >= ntol) & ~stagnant & ~cycling

    inf = torch.full(lam.shape[:1], float("inf"), dtype=lam.dtype, device=lam.device)
    lam, _, _ = masked_fixpoint(body, (lam, inf, active), niter, check_every)
    return lam


def ctm_vsq_newton(lam, vsq, logzeta, C, invsigma_diag, active,
                   niter: int, ntol: float, check_every: int = CHECK_EVERY):
    """Batched per-coordinate CTM vsq Newton with back-tracking
    (CTM.jl:146-165); each (document, topic) stops on its own, with the
    same f32 stops as :func:`ctm_lambda_newton`."""

    def body(i, carry):
        vsq, prev_norm, act = carry
        e = C[:, None] * _exp_safe(lam + 0.5 * vsq - logzeta[:, None])
        grad = -0.5 * (invsigma_diag[None, :] + e - 1.0 / vsq)
        invhess = -1.0 / (0.25 * e + 0.5 / vsq**2)
        p = invhess * grad
        rho = _backtrack_rho(vsq, p, strict=True)
        vsq_new = torch.where(act, vsq - rho * p, vsq)
        sn = rho * torch.abs(p)
        stagnant = sn <= 1e-5 * (torch.abs(vsq_new) + 1e-12)
        cycling = (sn >= prev_norm) & (i >= 8)
        return vsq_new, sn, act & (rho * torch.abs(grad) >= ntol) & ~stagnant & ~cycling

    act0 = active[:, None] & torch.ones_like(vsq, dtype=torch.bool)
    vsq, _, _ = masked_fixpoint(body, (vsq, torch.full_like(vsq, float("inf")), act0),
                                niter, check_every)
    # @positive model.vsq[d] (CTM.jl:164)
    return vsq + EPSILON
