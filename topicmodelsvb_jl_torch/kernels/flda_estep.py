"""fLDA E-step: the CUDA kernel's wrapper and its plain PyTorch version.

The kernel (``csrc/flda_estep.cu``) replaces the JAX package's Pallas
kernel ``flda_estep``.  Both versions here take the same arguments:

  logbetaT: [V, K]  log(beta + EPSILON)ᵀ; each document's rows are
                    gathered by ``terms`` inside the function
  kappa:    [V]     background distribution
  terms:    [B, L]  int32 0-based vocab ids
  counts:   [B, L]  token counts, 0 on padding
  doc_mask: [B]     1 for real documents
  alpha:    [K];  eta: 0-dim tensor on the same device
  gamma, El, El_old: [B, K];  tau, tau_old: [B, L] per-document state

and return ``(gamma, El, El_old, tau, tau_old, w)`` with ``w`` [B, L, K+1]:
``w[..., :K] = phi·tau·counts`` (phi taken from the final ``tau_old`` and
``El_old``) and ``w[..., K] = (1 − tau)·counts``, the beta and kappa
M-step statistics side by side for one scatter.  A document with
``doc_mask = 0`` keeps its state; tau is updated on every slot of a real
document, padding slots included, as the JAX package does.

phi ∝ exp(tau·log beta + El) over K (fLDA.jl:204-207) and
tau = eta / (eta + (1 − eta)·kappa·exp(−Σ_k phi·log beta) + EPSILON)
(fLDA.jl:195-200); ψ is the kernels' shift-by-8 series, or with
``elogtheta_f64=True`` the f64 Elogtheta channel as in ``lda_estep``
(``lda_estep.elogtheta``; the kernel's f64-channel mode).  On a float64
state the kernel runs its float64 mode, and the channel is the identity,
as for ``lda_estep``.

:func:`flda_estep_pass` is the kernel's pass mode, for the sequence axis,
where each document's token slots are split over ranks: one pass's
partial gamma statistic and the new tau on this rank's slots; the
caller sums the statistic over the ranks between passes, and
:func:`flda_split_fixpoint` drives it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..utils.numerics import EPSILON, masked_fixpoint
from . import _build
from ._build import check, require
from .lda_estep import elogtheta


def _phi(lb, tau, El):
    """Unnormalised phi = exp(tau·log beta + El − max) on gathered rows
    [B, L, K], and its sum over K."""
    logits = tau[:, :, None] * lb + El[:, None, :]
    p = torch.exp(logits - torch.amax(logits, dim=-1, keepdim=True))
    return p, torch.sum(p, dim=-1)


def _pass(lb, kap, counts, eta, El, tau):
    """One pass on gathered rows: (Σ_l phi_l·c_l [B, K], tau_new [B, L])."""
    p, s = _phi(lb, tau, El)
    philog = torch.sum(p * lb, dim=-1) / s
    tau_new = eta / (eta + (1.0 - eta) * kap * torch.exp(-philog) + EPSILON)
    return torch.sum(p * (counts / s)[:, :, None], dim=1), tau_new


def _update(carry, pc, tau_new, alpha, vtol2, elogtheta_f64):
    """The fixpoint's update on the [B, K] and [B, L] tiles from one pass's
    summed statistic and new tau: gamma, ψ, the masked state and the
    per-document stop test on El."""
    gamma, El, El_old, tau, tau_old, active = carry
    gamma_new = alpha + pc + EPSILON
    El_new = elogtheta(gamma_new, elogtheta_f64)
    upd = active[:, None]
    gamma2 = torch.where(upd, gamma_new, gamma)
    El_old2 = torch.where(upd, El, El_old)
    El2 = torch.where(upd, El_new, El)
    tau_old2 = torch.where(upd, tau, tau_old)
    tau2 = torch.where(upd, tau_new, tau)
    d = El2 - El_old2
    return (gamma2, El2, El_old2, tau2, tau_old2,
            active & (torch.sum(d * d, -1) >= vtol2))


def flda_estep_ref(logbetaT, kappa, terms, counts, doc_mask, alpha, eta,
                   gamma, El, El_old, tau, tau_old, *, viter: int, vtol: float,
                   elogtheta_f64: bool = False):
    """Plain PyTorch version of the kernel: the batch of documents runs
    the fixpoint together, each document frozen once it converges."""
    lb = logbetaT[terms]                               # [B, L, K]
    kap = kappa[terms]                                 # [B, L]
    vtol2 = vtol * vtol

    def body(_, carry):
        pc, tau_new = _pass(lb, kap, counts, eta, carry[1], carry[3])
        return _update(carry, pc, tau_new, alpha, vtol2, elogtheta_f64)

    gamma, El, El_old, tau, tau_old, _ = masked_fixpoint(
        body, (gamma, El, El_old, tau, tau_old, doc_mask > 0), viter)
    p, s = _phi(lb, tau_old, El_old)
    wb = p * ((tau * counts) / s)[:, :, None]
    wk = (1.0 - tau) * counts
    return gamma, El, El_old, tau, tau_old, torch.cat([wb, wk[:, :, None]], dim=-1)


def _argtypes(vtol_type, n_flags: int) -> list:
    return [ctypes.c_void_p] * 19 + [ctypes.c_int64] * 3 + [
        ctypes.c_int, vtol_type] + [ctypes.c_int] * n_flags + [ctypes.c_void_p]


# each mode's C entry point, its argument types (vtol in the state's
# dtype; the float32 mode's second flag picks the f64 Elogtheta channel)
# and the suffix of its shared-memory queries
_MODES = {torch.float32: ("tmvb_flda_estep", _argtypes(ctypes.c_float, 2), ""),
          torch.float64: ("tmvb_flda_estep_f64", _argtypes(ctypes.c_double, 1), "_f64")}


@functools.lru_cache(maxsize=None)
def _scratch_elems(L: int, K: int, suffix: str = "") -> int:
    """Elements of device scratch one document of L slots needs: 0 when
    its slot list fits shared memory (the main path's widths)."""
    got = _build.function(f"tmvb_flda_estep_scratch{suffix}", [ctypes.c_int64] * 2,
                          ctypes.c_int64)(L, K)
    if got < 0:
        raise RuntimeError(f"flda_estep: K = {K} does not fit the device's shared memory "
                           f"{'in float64 ' if suffix else ''}(or it cannot be queried)")
    return got


def flda_estep(logbetaT, kappa, terms, counts, doc_mask, alpha, eta,
               gamma, El, El_old, tau, tau_old, *, viter: int, vtol: float,
               elogtheta_f64: bool = False):
    """Run the fLDA E-step over a chunk of documents (arguments: module
    doc).  CPU tensors take :func:`flda_estep_ref`; CUDA tensors launch
    the kernel or raise: its float32 mode (``elogtheta_f64`` selects the
    f64-channel mode) or, on a float64 state, its float64 mode (every
    float argument float64; ``elogtheta_f64`` is the identity there)."""
    if logbetaT.device.type == "cpu":
        return flda_estep_ref(logbetaT, kappa, terms, counts, doc_mask, alpha, eta,
                              gamma, El, El_old, tau, tau_old, viter=viter, vtol=vtol,
                              elogtheta_f64=elogtheta_f64)
    if logbetaT.device.type != "cuda":
        raise ValueError(f"flda_estep: no kernel for device {logbetaT.device}")
    if terms.dim() != 2 or logbetaT.dim() != 2:
        raise ValueError("flda_estep: terms and logbetaT must be 2-D")
    B, L = terms.shape
    V, K = logbetaT.shape
    dt = logbetaT.dtype
    if dt not in _MODES:
        raise TypeError(f"flda_estep: logbetaT must be torch.float32 or torch.float64, "
                        f"got {dt}")
    entry, argtypes, suffix = _MODES[dt]
    require("flda_estep", logbetaT.device, {
        "logbetaT": (logbetaT, (V, K), dt), "kappa": (kappa, (V,), dt),
        "terms": (terms, (B, L), torch.int32), "counts": (counts, (B, L), dt),
        "doc_mask": (doc_mask, (B,), dt), "alpha": (alpha, (K,), dt),
        "eta": (eta, (), dt), "gamma": (gamma, (B, K), dt),
        "El": (El, (B, K), dt), "El_old": (El_old, (B, K), dt),
        "tau": (tau, (B, L), dt), "tau_old": (tau_old, (B, L), dt)})
    outs = [torch.empty_like(gamma) for _ in range(3)]
    taus = [torch.empty_like(tau) for _ in range(2)]
    w = torch.empty((B, L, K + 1), dtype=dt, device=logbetaT.device)
    if B == 0:
        return (*outs, *taus, w)
    n_scratch = _scratch_elems(L, K, suffix)
    scratch = (torch.empty((B, n_scratch), dtype=dt, device=logbetaT.device)
               if n_scratch else None)
    # 16-byte copies of the table's rows: 4 floats or 2 doubles
    flags = [K % (16 // logbetaT.element_size()) == 0 and logbetaT.data_ptr() % 16 == 0]
    if dt == torch.float32:
        flags.append(bool(elogtheta_f64))
    err = _build.launch(
        _build.function(entry, argtypes), logbetaT.device,
        *(t.data_ptr() for t in (logbetaT, kappa, terms, counts, doc_mask, alpha, eta, gamma,
                                 El, El_old, tau, tau_old, *outs, *taus, w)),
        None if scratch is None else scratch.data_ptr(), B, L, K, int(viter), float(vtol),
        *map(int, flags))
    check(err, "flda_estep")
    flda_estep.launches += 1
    if dt == torch.float64:
        flda_estep.launches_double += 1
    else:
        flda_estep.launches_f64 += bool(elogtheta_f64)
    return (*outs, *taus, w)


flda_estep.launches = 0   # kernel launches (the plain version is not counted)
flda_estep.launches_f64 = 0   # of them, launches of the f64-channel mode (f32 state)
flda_estep.launches_double = 0   # of them, launches of the float64 mode


def flda_estep_pass_ref(logbetaT, kappa, terms, counts, doc_mask, eta, El, tau):
    """Plain PyTorch version of the pass mode: ``pc [B, K] = Σ_l phi_l·c_l``
    with ``phi ∝ exp(tau·log beta + El)`` over the slots given, and
    ``tau_new [B, L]`` on every slot (fLDA.jl:195-200); a document with
    ``doc_mask`` 0 gets ``pc = 0`` and ``tau_new = tau``."""
    pc, tau_new = _pass(logbetaT[terms], kappa[terms], counts, eta, El, tau)
    act = (doc_mask > 0)[:, None]
    return torch.where(act, pc, torch.zeros_like(pc)), torch.where(act, tau_new, tau)


_PASS_ARGTYPES = [ctypes.c_void_p] * 11 + [ctypes.c_int64] * 3 + [ctypes.c_int, ctypes.c_void_p]


def flda_estep_pass(logbetaT, kappa, terms, counts, doc_mask, eta, El, tau):
    """One pass of the fLDA fixpoint without its update: this rank's
    partial statistic ``pc [B, K]`` and ``tau_new [B, L]`` (see
    :func:`flda_estep_pass_ref`).  CPU tensors take
    :func:`flda_estep_pass_ref`; CUDA tensors launch the kernel or raise:
    its float32 mode or, on a float64 table, its float64 mode (every
    float argument float64)."""
    if logbetaT.device.type == "cpu":
        return flda_estep_pass_ref(logbetaT, kappa, terms, counts, doc_mask, eta, El, tau)
    if logbetaT.device.type != "cuda":
        raise ValueError(f"flda_estep_pass: no kernel for device {logbetaT.device}")
    if terms.dim() != 2 or logbetaT.dim() != 2:
        raise ValueError("flda_estep_pass: terms and logbetaT must be 2-D")
    B, L = terms.shape
    V, K = logbetaT.shape
    dt = logbetaT.dtype
    if dt not in _MODES:
        raise TypeError(f"flda_estep_pass: logbetaT must be torch.float32 or torch.float64, "
                        f"got {dt}")
    suffix = _MODES[dt][2]
    require("flda_estep_pass", logbetaT.device, {
        "logbetaT": (logbetaT, (V, K), dt), "kappa": (kappa, (V,), dt),
        "terms": (terms, (B, L), torch.int32), "counts": (counts, (B, L), dt),
        "doc_mask": (doc_mask, (B,), dt), "eta": (eta, (), dt),
        "El": (El, (B, K), dt), "tau": (tau, (B, L), dt)})
    pc = torch.empty((B, K), dtype=dt, device=logbetaT.device)
    tau_new = torch.empty_like(tau)
    if B == 0:
        return pc, tau_new
    n_scratch = _scratch_elems(L, K, suffix)
    scratch = (torch.empty((B, n_scratch), dtype=dt, device=logbetaT.device)
               if n_scratch else None)
    err = _build.launch(
        _build.function(f"tmvb_flda_estep_pass{suffix}", _PASS_ARGTYPES), logbetaT.device,
        *(t.data_ptr() for t in (logbetaT, kappa, terms, counts, doc_mask, eta, El, tau, pc,
                                 tau_new)),
        None if scratch is None else scratch.data_ptr(), B, L, K,
        int(K % (16 // logbetaT.element_size()) == 0 and logbetaT.data_ptr() % 16 == 0))
    check(err, "flda_estep_pass")
    flda_estep_pass.launches += 1
    flda_estep_pass.launches_double += dt == torch.float64
    return pc, tau_new


flda_estep_pass.launches = 0   # kernel launches (the plain version is not counted)
flda_estep_pass.launches_double = 0   # of them, launches of the float64 mode


def flda_split_fixpoint(logbetaT, kappa, terms, counts, doc_mask, alpha, eta, gamma, El,
                        El_old, tau, tau_old, *, viter: int, vtol: float, reduce=None,
                        elogtheta_f64: bool = False):
    """The fLDA E-step over a chunk whose token slots are split over ranks
    (the sequence axis): :func:`flda_estep`'s fixpoint with each pass's
    statistic and tau from :func:`flda_estep_pass`, the statistic summed
    by ``reduce`` (the psum over the ranks that hold the documents' other
    slots; None on one rank), and gamma, ψ (in float64 with
    ``elogtheta_f64``), the masks, tau and the per-document stop test on
    the tiles, as the JAX package computes them on this path
    (models/flda.py ``_estep_chunk``).  Returns ``(gamma, El, El_old,
    tau, tau_old, w)``, ``w`` [B, L, K+1] over this rank's slots from the
    kernel at ``viter = 0`` (phi from ``tau_old`` and the final
    ``El_old``, the weights from the final tau).  Every rank of a
    ``reduce`` group holds the same documents, so they test the same mask
    and stop together."""
    vtol2 = vtol * vtol

    def body(_, carry):
        pc, tau_new = flda_estep_pass(logbetaT, kappa, terms, counts,
                                      carry[5].to(counts.dtype), eta, carry[1], carry[3])
        if reduce is not None:
            pc = reduce(pc)
        return _update(carry, pc, tau_new, alpha, vtol2, elogtheta_f64)

    gamma, El, El_old, tau, tau_old, _ = masked_fixpoint(
        body, (gamma, El, El_old, tau, tau_old, doc_mask > 0), viter)
    return flda_estep(logbetaT, kappa, terms, counts, doc_mask, alpha, eta, gamma, El, El_old,
                      tau, tau_old, viter=0, vtol=vtol)
