"""Dirichlet hyperparameter Newton (reference LDA.jl:97-118).

Interior-point Newton with a log barrier and back-tracking, run on the
device that holds alpha.  The JAX package's ``lax.while_loop`` becomes
a Python loop; its ``done`` test reads one value back to the host each
iteration.
"""

from __future__ import annotations

import torch

from ..utils.numerics import EPSILON, digamma, finite, l2norm, trigamma


def dirichlet_newton(
    alpha: torch.Tensor,
    Elogtheta_sum: torch.Tensor,
    M: float,
    niter: int,
    ntol: float,
    Elogtheta_sum_lo: torch.Tensor = None,
) -> torch.Tensor:
    """Interior-point Newton for the Dirichlet parameter (LDA.jl:97-118).

    The gradient is evaluated in MEAN form — ``M·(nu/(M·alpha) + ψ(Σa)
    − ψ(a_k) + Elogtheta_sum/M)`` — so the near-cancellation at the
    optimum resolves at the ulp of O(1) quantities instead of
    O(M·|Elogtheta|).  ``Elogtheta_sum_lo`` carries the compensation
    half of a Kahan-accumulated sum (models/lda.py's step carry) into
    the mean at full precision.
    """
    K = alpha.shape[0]
    dtype = alpha.dtype
    M = torch.as_tensor(M, dtype=dtype, device=alpha.device)
    nu = float(K)
    el_mean = Elogtheta_sum / M
    if Elogtheta_sum_lo is not None:
        el_mean = el_mean + Elogtheta_sum_lo / M

    prev_norm = torch.tensor(float("inf"), dtype=dtype, device=alpha.device)
    for i in range(niter):
        a0 = torch.sum(alpha)
        grad = M * (nu / (M * alpha) + digamma(a0) - digamma(alpha) + el_mean)
        h_inv = -1.0 / (M * trigamma(alpha) + nu / alpha**2)
        denom = 1.0 / (M * trigamma(a0)) + torch.sum(h_inv)
        p = (grad - torch.dot(grad, h_inv) / denom) * h_inv

        # back-tracking: minimum(alpha - rho*p) must stay >= 0
        # (LDA.jl:107-109).  The reference halves rho from 1; the final
        # value is the largest 2^-m with rho <= min_k alpha_k/p_k over
        # descending coordinates, computed here in closed form.
        pos = p > 0
        ratio = torch.where(pos, alpha / torch.where(pos, p, torch.ones_like(p)),
                            torch.full_like(p, float("inf")))
        r_star = torch.min(ratio)
        m = torch.clamp(torch.ceil(-torch.log2(torch.clamp(r_star, max=1.0))),
                        min=0.0)
        rho = torch.exp2(-m)
        # division can round alpha/p up across the power-of-two boundary;
        # validate the actual step like the reference's while-condition
        rho = torch.where(torch.min(alpha - rho * p) < 0, rho * 0.5, rho)

        alpha_new = finite(alpha - rho * p)
        # reference stopping rule (LDA.jl:113-115) — plus, on f32 only,
        # two numerical stops: a step below f32 resolution of alpha makes
        # no progress, and once the barrier has annealed away a step that
        # stops contracting is a limit cycle.  f64 keeps the reference's
        # own rule alone.
        sn = rho * l2norm(p)
        annealed = nu / K < ntol
        done = (rho * l2norm(grad) < ntol) & annealed
        if dtype == torch.float32:
            stagnant = sn <= 1e-6 * (l2norm(alpha) + 1.0)
            cycling = (sn >= prev_norm) & (annealed and i >= 20)
            done = done | stagnant | cycling
        alpha = alpha_new
        nu *= 0.5
        prev_norm = sn
        if bool(done):
            break
    # @positive model.alpha (LDA.jl:117)
    return alpha + EPSILON
