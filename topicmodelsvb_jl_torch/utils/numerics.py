"""Numeric utilities and constants (reference ``src/utils.jl``).

* ``EPSILON`` underflow guard (utils.jl:3) — ``eps(1e-14) ≈ 1.6e-30``.
* ``finite`` overflow clamp (utils.jl:107).
* ``logsumexp`` (utils.jl:110).
* Dirichlet entropy closed form (utils.jl:163-180), and the categorical,
  Bernoulli, Gamma and diagonal-normal entropies of the fLDA, CTPF and
  CTM bounds.
* digamma/lgamma/trigamma from ``torch.special``: unlike a TPU's vector
  unit, CUDA and CPU evaluate ``log``/``lgamma`` to within a few ULP, so
  no hand-built transcendentals are needed.
* The compensated (Kahan–Neumaier) ``kbn_*`` accumulation that carries
  the corpus bound and the Elogtheta sum as an unevaluated (hi, lo) pair.

Everything is dtype-polymorphic: f32 on the GPU, f64 for the CPU oracle
(the reference's GPU-f32/CPU-f64 split, gpuLDA.jl:14-21 vs LDA.jl:14-21).
"""

from __future__ import annotations

import math

import numpy as np
import torch

# Underflow guard: Julia eps(1e-14) (reference utils.jl:3).  Still a normal
# float32 (> 1.18e-38), matching the reference's EPSILON32 = 1e-30 (utils.jl:6).
EPSILON = float(np.spacing(1e-14))  # 1.6033346880071782e-30


def finite(x: torch.Tensor) -> torch.Tensor:
    """Clamp ±Inf overflow to ±floatmax (reference utils.jl:107)."""
    fmax = torch.finfo(x.dtype).max
    return torch.clamp(x, -fmax, fmax)


def l2norm(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return torch.sqrt(torch.sum(x * x, dim=dim))


def logsumexp(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Overflow-safe log-sum-exp over ``dim`` (reference utils.jl:110)."""
    m = torch.amax(x, dim=dim, keepdim=True)
    return (torch.log(torch.sum(torch.exp(x - m), dim=dim, keepdim=True)) + m).squeeze(dim)


def digamma(x: torch.Tensor) -> torch.Tensor:
    return torch.special.digamma(x)


def trigamma(x: torch.Tensor) -> torch.Tensor:
    return torch.special.polygamma(1, x)


def lgamma(x: torch.Tensor) -> torch.Tensor:
    return torch.special.gammaln(x)


def dirichlet_entropy(alpha: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Entropy of Dirichlet(alpha), patched closed form (utils.jl:163-180).

    en = lmnB + (α0 − k)·ψ(α0) − Σⱼ (αⱼ − 1)·ψ(αⱼ),
    lmnB = Σⱼ lnΓ(αⱼ) − lnΓ(α0).
    """
    a0 = torch.sum(alpha, dim=dim)
    k = alpha.shape[dim]
    lmnb = torch.sum(lgamma(alpha), dim=dim) - lgamma(a0)
    return (lmnb + (a0 - k) * digamma(a0)
            - torch.sum((alpha - 1.0) * digamma(alpha), dim=dim))


def xlogx(v: torch.Tensor) -> torch.Tensor:
    """v·log v with 0·log 0 = 0."""
    pos = v > 0
    return torch.where(pos, v * torch.log(torch.where(pos, v, torch.ones_like(v))),
                       torch.zeros_like(v))


def categorical_entropy(p: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """−Σ p log p with 0·log 0 = 0 (reference Elogqz terms, LDA.jl:76-80)."""
    return -torch.sum(xlogx(p), dim=dim)


def bernoulli_entropy(t: torch.Tensor) -> torch.Tensor:
    """Entropy of Bernoulli(t) with 0·log 0 = 0 (fLDA Elogqc, fLDA.jl:95-98)."""
    return -(xlogx(t) + xlogx(1.0 - t))


def gamma_entropy(shape: torch.Tensor, rate: torch.Tensor) -> torch.Tensor:
    """Entropy of Gamma(shape, scale=1/rate) (CTPF Elogq* terms, CTPF.jl:198-231).

    H = shape − log(rate) + lnΓ(shape) + (1 − shape)·ψ(shape).
    """
    return shape - torch.log(rate) + lgamma(shape) + (1.0 - shape) * digamma(shape)


def mvnormal_diag_entropy(vsq: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Entropy of N(·, diag(vsq)) (CTM Elogqeta, CTM.jl:76-79).

    H = K/2·(1 + log 2π) + ½·Σ log vsq.
    """
    k = vsq.shape[dim]
    return 0.5 * k * (1.0 + math.log(2.0 * math.pi)) + 0.5 * torch.sum(torch.log(vsq), dim=dim)


def dirichlet_ones(generator: torch.Generator, n: int, shape: tuple = (),
                   dtype=torch.float32) -> torch.Tensor:
    """Dirichlet(1,…,1) rows of width ``n``: normalised iid Exp(1) draws,
    on ``generator``'s device (reference init: LDA.jl:33)."""
    e = torch.empty(tuple(shape) + (n,), dtype=dtype, device=generator.device)
    e.exponential_(generator=generator)
    return e / torch.sum(e, dim=-1, keepdim=True)


def masked_fixpoint(body, carry: tuple, viter: int, check_every: int = 1) -> tuple:
    """Run ``body(i, carry)`` up to ``viter`` times, stopping once the
    carry's LAST entry (a per-lane ``active`` bool mask) is all False.

    The per-document viter loop of the reference runs batch-synchronously
    with converged lanes frozen by the body (the break at LDA.jl:175), and
    so do the CTM Newtons and their CG solve; passes after every lane has
    stopped leave the results as they were, so stopping early is
    trajectory-neutral.  Each test of the mask reads one value back to the
    host, which waits for the device.  The mask is tested before every
    ``check_every``-th pass only: the passes between two tests are queued
    without a wait, and the result is bit-identical to testing every pass."""
    if check_every < 1:
        raise ValueError("check_every must be positive")
    i = 0
    while i < viter and bool(torch.any(carry[-1])):
        for _ in range(min(check_every, viter - i)):
            carry = body(i, carry)
            i += 1
    return carry


# ── compensated (Kahan–Neumaier) accumulation ──
#
# A corpus bound at NSF scale has magnitude ~1.4e8, where the f32 ulp is
# 16 — far above the reference's default stopping tolerance tol=1.0
# (LDA.jl:161).  Carrying the bound as an UNEVALUATED (hi, lo) pair, with
# a Neumaier two-sum per chunk partial and the final combination in f64
# on the host (``elbo_value``), keeps ∆elbo resolvable below tol.

def kbn_zero(dtype, device=None) -> tuple:
    """Fresh (hi, lo) compensated accumulator."""
    z = torch.zeros((), dtype=dtype, device=device)
    return (z, z)


def kbn_zeros(shape, dtype, device=None) -> tuple:
    """Fresh tensor-shaped (hi, lo) compensated accumulator (kbn_add
    operates elementwise on any shape)."""
    z = torch.zeros(shape, dtype=dtype, device=device)
    return (z, z)


def kbn_add(acc: tuple, x: torch.Tensor) -> tuple:
    """Neumaier two-sum: add ``x`` into the (hi, lo) pair."""
    hi, lo = acc
    s = hi + x
    e = torch.where(torch.abs(hi) >= torch.abs(x), (hi - s) + x, (x - s) + hi)
    return (s, lo + e)


def kbn_merge(a: tuple, b: tuple) -> tuple:
    """Merge two (hi, lo) pairs into one."""
    return kbn_add((a[0], a[1] + b[1]), b[0])


def kbn_psum(acc: tuple, mesh=None, axes=()) -> tuple:
    """Compensated reduction of a (hi, lo) pair over a mesh axis
    (elementwise, any shape), as the JAX package's ``kbn_psum``: the hi
    parts are gathered and folded in rank order with two-sum, starting
    from zeros, and the lo parts, far below ulp(total), are summed.
    Returns ``acc`` itself when nothing is reduced; over one process the
    result equals ``acc`` bit for bit."""
    from ..parallel import shard

    if shard._group(mesh, axes) is None:
        return acc
    hi, lo = acc
    hs = shard.all_gather(hi, mesh, axes)
    out = (torch.zeros_like(hi), shard.psum(lo, mesh, axes))
    for i in range(hs.shape[0]):
        out = kbn_add(out, hs[i])
    return out


def kbn_pack(acc: tuple) -> torch.Tensor:
    """(hi, lo) pair → shape-(2,) tensor (the ELBO return convention)."""
    return torch.stack([acc[0], acc[1]])


def elbo_value(e) -> float:
    """Float64 value of an ELBO — a compensated shape-(2,) (hi, lo) pair,
    or a plain scalar.  Reading a device tensor waits for the device."""
    if isinstance(e, torch.Tensor):
        e = e.detach().to("cpu", torch.float64).numpy()
    a = np.asarray(e, np.float64)
    return float(a.sum()) if a.ndim else float(a)
