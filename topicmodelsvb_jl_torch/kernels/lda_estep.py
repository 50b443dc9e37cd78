"""LDA E-step: the CUDA kernel's wrapper and its plain PyTorch version.

The kernel (``csrc/lda_estep.cu``) replaces the JAX package's Pallas
kernel ``lda_estep``.  Both versions here take the same arguments:

  betaT:    [V, K]  (beta + EPSILON)ᵀ — the reference's @boink guard folded
                    into the table; each document's rows are gathered by
                    ``terms`` inside the function
  terms:    [B, L]  int32 0-based vocab ids
  counts:   [B, L]  token counts, 0 on padding
  doc_mask: [B]     1 for real documents
  alpha:    [K]
  gamma, El, El_old: [B, K] per-document variational state

and return ``(gamma, El, El_old, w)`` with ``w = phi·counts`` [B, L, K],
phi taken from the final ``El_old``.  A document with ``doc_mask = 0``
keeps its state.

:func:`lda_estep_pass` is the kernel's pass mode, for the modes whose
token slots are split over ranks (routed tensor parallelism, the
sequence axis): one pass's partial document statistic, which the caller
sums over the ranks between passes; :func:`split_fixpoint` drives it.

phi is computed multiplicatively — ``phi ∝ (beta+eps)[:, terms]·exp(El)``
— exactly the CPU reference's update (LDA.jl:150-154 under @positive),
and ψ is the shift-by-8 asymptotic series of the reference's OpenCL
``DIGAMMA_c`` (utils.jl:21-53).

``elogtheta_f64=True`` is the f64 Elogtheta channel
(``RuntimeConfig.elogtheta_f64``): gamma is formed in the state's dtype,
and ``ψ(γ) − ψ(Σγ)`` is taken in float64 and cast back
(:func:`elogtheta`); the token-level work stays in the state's dtype.
The kernel has it as a mode (a double series, ``digamma_series64`` in
``csrc/common.cuh``); the plain versions take ψ from ``torch.special``,
as the JAX package's float64 ``digamma`` does.

On a float64 state the kernel runs its float64 mode: the same fixpoint
with every tensor in float64 and ψ the same shift-by-8 series in double,
what :func:`lda_estep_ref` computes on that state (its truncation,
~2.5e-10, is the plain version's too).  ``elogtheta_f64`` is the
identity there, as in the JAX package, which casts a float64 gamma to
float64.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..utils.numerics import EPSILON, masked_fixpoint
from . import _build
from ._build import check, require


def digamma_series(x: torch.Tensor) -> torch.Tensor:
    """ψ(x) for x > 0 via recurrence + asymptotic series (f32-accurate).

    ψ(x) = ψ(x+8) − Σ_{i=0..7} 1/(x+i);  for t ≥ 8:
    ψ(t) ≈ ln t − 1/(2t) − 1/(12t²) + 1/(120t⁴) − 1/(252t⁶).
    Truncation error at t = 8 is ~2.5e-10 — below f32 resolution.
    """
    acc = torch.zeros_like(x)
    for i in range(8):
        acc = acc + 1.0 / (x + float(i))
    t = x + 8.0
    inv = 1.0 / t
    inv2 = inv * inv
    series = (torch.log(t) - 0.5 * inv
              - inv2 * (1.0 / 12.0 - inv2 * (1.0 / 120.0 - inv2 * (1.0 / 252.0))))
    return series - acc


def elogtheta(gamma_new: torch.Tensor, f64: bool = False) -> torch.Tensor:
    """Elogtheta from gamma, ``ψ(γ) − ψ(Σ_k γ)`` over the last axis
    (LDA.jl:136-139): the kernels' series in the state's dtype, or with
    ``f64`` on a float32 state in float64 from the state's gamma, cast
    back (the JAX package's ``elogtheta_f64``, models/lda.py:137-141).  On
    a float64 state ``f64`` is the identity: ψ is the state's own."""
    if f64 and gamma_new.dtype != torch.float64:
        g64 = gamma_new.to(torch.float64)
        return (torch.special.digamma(g64)
                - torch.special.digamma(torch.sum(g64, -1, keepdim=True))).to(gamma_new.dtype)
    return digamma_series(gamma_new) - digamma_series(torch.sum(gamma_new, -1, keepdim=True))


def lda_estep_ref(betaT, terms, counts, doc_mask, alpha, gamma, El, El_old,
                  *, viter: int, vtol: float, elogtheta_f64: bool = False):
    """Plain PyTorch version of the kernel: the batch of documents runs
    the fixpoint together, each document frozen once it converges."""
    bd = betaT[terms]                                  # [B, L, K]
    vtol2 = vtol * vtol

    def body(_, carry):
        gamma, El, El_old, active = carry
        e = torch.exp(El)                              # [B, K]
        s = torch.sum(bd * e[:, None, :], dim=-1)      # [B, L]
        cs = counts / s
        q = torch.sum(bd * cs[:, :, None], dim=1)      # [B, K]
        gamma_new = alpha + e * q + EPSILON
        El_new = elogtheta(gamma_new, elogtheta_f64)
        upd = active[:, None]
        gamma2 = torch.where(upd, gamma_new, gamma)
        El_old2 = torch.where(upd, El, El_old)
        El2 = torch.where(upd, El_new, El)
        d = El2 - El_old2
        return gamma2, El2, El_old2, active & (torch.sum(d * d, -1) >= vtol2)

    gamma, El, El_old, _ = masked_fixpoint(
        body, (gamma, El, El_old, doc_mask > 0), viter)
    e = torch.exp(El_old)
    s = torch.sum(bd * e[:, None, :], dim=-1)
    w = bd * (e[:, None, :] * (counts / s)[:, :, None])
    return gamma, El, El_old, w


def _argtypes(vtol_type, n_flags: int) -> list:
    return [ctypes.c_void_p] * 13 + [ctypes.c_int64] * 3 + [
        ctypes.c_int, vtol_type] + [ctypes.c_int] * n_flags + [ctypes.c_void_p]


# each mode's C entry point, its argument types (vtol in the state's
# dtype; the float32 mode's third flag picks the f64 Elogtheta channel)
# and the suffix of its shared-memory queries
_MODES = {torch.float32: ("tmvb_lda_estep", _argtypes(ctypes.c_float, 3), ""),
          torch.float64: ("tmvb_lda_estep_f64", _argtypes(ctypes.c_double, 2), "_f64")}


@functools.lru_cache(maxsize=None)
def _scratch_elems(L: int, K: int, suffix: str = "") -> int:
    """Elements of device scratch one document of L slots needs: 0 when
    its slot list fits shared memory (the main path's widths)."""
    got = _build.function(f"tmvb_lda_estep_scratch{suffix}", [ctypes.c_int64] * 2,
                          ctypes.c_int64)(L, K)
    if got < 0:
        raise RuntimeError(f"lda_estep: K = {K} does not fit the device's shared memory "
                           f"{'in float64 ' if suffix else ''}(or it cannot be queried)")
    return got


def lda_estep(betaT, terms, counts, doc_mask, alpha, gamma, El, El_old,
              *, viter: int, vtol: float, elogtheta_f64: bool = False):
    """Run the E-step over a chunk of documents (arguments: module doc).

    CPU tensors take :func:`lda_estep_ref`; CUDA tensors launch the
    kernel or raise: its float32 mode (``elogtheta_f64`` selects the
    f64-channel mode) or, on a float64 state, its float64 mode (every
    float argument float64; ``elogtheta_f64`` is the identity there)."""
    if betaT.device.type == "cpu":
        return lda_estep_ref(betaT, terms, counts, doc_mask, alpha, gamma,
                             El, El_old, viter=viter, vtol=vtol,
                             elogtheta_f64=elogtheta_f64)
    if betaT.device.type != "cuda":
        raise ValueError(f"lda_estep: no kernel for device {betaT.device}")
    if terms.dim() != 2 or betaT.dim() != 2:
        raise ValueError("lda_estep: terms and betaT must be 2-D")
    B, L = terms.shape
    V, K = betaT.shape
    dt = betaT.dtype
    if dt not in _MODES:
        raise TypeError(f"lda_estep: betaT must be torch.float32 or torch.float64, got {dt}")
    entry, argtypes, suffix = _MODES[dt]
    require("lda_estep", betaT.device, {
        "betaT": (betaT, (V, K), dt), "terms": (terms, (B, L), torch.int32),
        "counts": (counts, (B, L), dt), "doc_mask": (doc_mask, (B,), dt),
        "alpha": (alpha, (K,), dt), "gamma": (gamma, (B, K), dt),
        "El": (El, (B, K), dt), "El_old": (El_old, (B, K), dt)})
    outs = [torch.empty_like(gamma) for _ in range(3)]
    w = torch.empty((B, L, K), dtype=dt, device=betaT.device)
    if B == 0:
        return (*outs, w)
    n_scratch = _scratch_elems(L, K, suffix)
    scratch = (torch.empty((B, n_scratch), dtype=dt, device=betaT.device)
               if n_scratch else None)
    # 16-byte copies of the table's rows (4 floats or 2 doubles), and
    # 4-wide stores of w
    flags = [K % (16 // betaT.element_size()) == 0 and betaT.data_ptr() % 16 == 0,
             K % 4 == 0 and w.data_ptr() % 16 == 0]
    if dt == torch.float32:
        flags.append(bool(elogtheta_f64))
    err = _build.launch(
        _build.function(entry, argtypes), betaT.device,
        *(t.data_ptr() for t in (betaT, terms, counts, doc_mask, alpha, gamma, El, El_old,
                                 *outs, w)),
        None if scratch is None else scratch.data_ptr(), B, L, K, int(viter), float(vtol),
        *map(int, flags))
    check(err, "lda_estep")
    lda_estep.launches += 1
    if dt == torch.float64:
        lda_estep.launches_double += 1
    else:
        lda_estep.launches_f64 += bool(elogtheta_f64)
    return (*outs, w)


lda_estep.launches = 0   # kernel launches (the plain version is not counted)
lda_estep.launches_f64 = 0   # of them, launches of the f64-channel mode (f32 state)
lda_estep.launches_double = 0   # of them, launches of the float64 mode


def lda_estep_pass_ref(betaT, terms, counts, doc_mask, El):
    """Plain PyTorch version of the pass mode: ``pc [B, K] = e ⊙ q``,
    ``e = exp(El)``, ``q_k = Σ_l (c_l / s_l)·betaT[t_l, k]`` with each
    token's own normaliser ``s_l = Σ_k betaT[t_l, k]·e_k`` over the slots
    and the table given; 0 for a document with ``doc_mask`` 0."""
    bd = betaT[terms]                                  # [B, L, K]
    e = torch.exp(El)
    s = torch.sum(bd * e[:, None, :], dim=-1)          # [B, L]
    q = torch.sum(bd * (counts / s)[:, :, None], dim=1)
    return torch.where((doc_mask > 0)[:, None], e * q, torch.zeros_like(q))


_PASS_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int64] * 3 + [ctypes.c_int, ctypes.c_void_p]


def lda_estep_pass(betaT, terms, counts, doc_mask, El):
    """One pass of the E-step fixpoint without its update: this rank's
    partial statistic ``pc [B, K]`` (see :func:`lda_estep_pass_ref`).

    CPU tensors take :func:`lda_estep_pass_ref`; CUDA tensors launch the
    kernel or raise: its float32 mode or, on a float64 table, its float64
    mode (every float argument float64)."""
    if betaT.device.type == "cpu":
        return lda_estep_pass_ref(betaT, terms, counts, doc_mask, El)
    if betaT.device.type != "cuda":
        raise ValueError(f"lda_estep_pass: no kernel for device {betaT.device}")
    if terms.dim() != 2 or betaT.dim() != 2:
        raise ValueError("lda_estep_pass: terms and betaT must be 2-D")
    B, L = terms.shape
    V, K = betaT.shape
    dt = betaT.dtype
    if dt not in _MODES:
        raise TypeError(f"lda_estep_pass: betaT must be torch.float32 or torch.float64, "
                        f"got {dt}")
    suffix = _MODES[dt][2]
    require("lda_estep_pass", betaT.device, {
        "betaT": (betaT, (V, K), dt), "terms": (terms, (B, L), torch.int32),
        "counts": (counts, (B, L), dt), "doc_mask": (doc_mask, (B,), dt),
        "El": (El, (B, K), dt)})
    pc = torch.empty((B, K), dtype=dt, device=betaT.device)
    if B == 0:
        return pc
    n_scratch = _scratch_elems(L, K, suffix)
    scratch = (torch.empty((B, n_scratch), dtype=dt, device=betaT.device)
               if n_scratch else None)
    err = _build.launch(
        _build.function(f"tmvb_lda_estep_pass{suffix}", _PASS_ARGTYPES), betaT.device,
        *(t.data_ptr() for t in (betaT, terms, counts, doc_mask, El, pc)),
        None if scratch is None else scratch.data_ptr(), B, L, K,
        int(K % (16 // betaT.element_size()) == 0 and betaT.data_ptr() % 16 == 0))
    check(err, "lda_estep_pass")
    lda_estep_pass.launches += 1
    lda_estep_pass.launches_double += dt == torch.float64
    return pc


lda_estep_pass.launches = 0   # kernel launches (the plain version is not counted)
lda_estep_pass.launches_double = 0   # of them, launches of the float64 mode


def split_fixpoint(betaT, terms, counts, doc_mask, alpha, gamma, El, El_old,
                   *, viter: int, vtol: float, reduce=None, elogtheta_f64: bool = False):
    """The E-step over a chunk whose token slots are split over ranks:
    :func:`lda_estep`'s fixpoint with each pass's statistic from
    :func:`lda_estep_pass`, summed by ``reduce`` (the psum over the ranks
    that hold the documents' other slots; None on one rank), and gamma,
    ψ, the masks and the per-document stop test on the [B, K] tiles, as
    the JAX package computes them outside any kernel on this path.
    Returns ``(gamma, El, El_old, w)``, ``w = phi·counts`` over this
    rank's slots from the kernel at ``viter = 0`` (the state unchanged,
    phi from the final ``El_old``).  Every rank of a ``reduce`` group
    holds the same documents, so they test the same mask and stop
    together.  ``elogtheta_f64`` takes ψ in float64 on the tiles
    (:func:`elogtheta`)."""
    vtol2 = vtol * vtol
    active = doc_mask > 0
    i = 0
    while i < viter and bool(torch.any(active)):
        pc = lda_estep_pass(betaT, terms, counts, active.to(counts.dtype), El)
        if reduce is not None:
            pc = reduce(pc)
        gamma_new = alpha + pc + EPSILON
        El_new = elogtheta(gamma_new, elogtheta_f64)
        upd = active[:, None]
        gamma = torch.where(upd, gamma_new, gamma)
        El_old = torch.where(upd, El, El_old)
        El = torch.where(upd, El_new, El)
        d = El - El_old
        active = active & (torch.sum(d * d, -1) >= vtol2)
        i += 1
    return lda_estep(betaT, terms, counts, doc_mask, alpha, gamma, El, El_old,
                     viter=0, vtol=vtol)
