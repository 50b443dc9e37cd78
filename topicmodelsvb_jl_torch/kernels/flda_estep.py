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
(``lda_estep.elogtheta``; the kernel's f64-channel mode).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..utils.numerics import EPSILON, masked_fixpoint
from . import _build
from ._build import check, require
from .lda_estep import elogtheta


def flda_estep_ref(logbetaT, kappa, terms, counts, doc_mask, alpha, eta,
                   gamma, El, El_old, tau, tau_old, *, viter: int, vtol: float,
                   elogtheta_f64: bool = False):
    """Plain PyTorch version of the kernel: the batch of documents runs
    the fixpoint together, each document frozen once it converges."""
    lb = logbetaT[terms]                               # [B, L, K]
    kap = kappa[terms]                                 # [B, L]
    vtol2 = vtol * vtol

    def phi(t, e):
        logits = t[:, :, None] * lb + e[:, None, :]
        p = torch.exp(logits - torch.amax(logits, dim=-1, keepdim=True))
        return p, torch.sum(p, dim=-1)

    def body(_, carry):
        gamma, El, El_old, tau, tau_old, active = carry
        p, s = phi(tau, El)
        philog = torch.sum(p * lb, dim=-1) / s
        tau_new = eta / (eta + (1.0 - eta) * kap * torch.exp(-philog) + EPSILON)
        cs = counts / s
        gamma_new = alpha + torch.sum(p * cs[:, :, None], dim=1) + EPSILON
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

    gamma, El, El_old, tau, tau_old, _ = masked_fixpoint(
        body, (gamma, El, El_old, tau, tau_old, doc_mask > 0), viter)
    p, s = phi(tau_old, El_old)
    wb = p * ((tau * counts) / s)[:, :, None]
    wk = (1.0 - tau) * counts
    return gamma, El, El_old, tau, tau_old, torch.cat([wb, wk[:, :, None]], dim=-1)


_ARGTYPES = [ctypes.c_void_p] * 19 + [ctypes.c_int64] * 3 + [
    ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


@functools.lru_cache(maxsize=None)
def _scratch_floats(L: int, K: int) -> int:
    """Floats of device scratch one document of L slots needs: 0 when its
    slot list fits shared memory (the main path's widths)."""
    got = _build.function("tmvb_flda_estep_scratch", [ctypes.c_int64] * 2, ctypes.c_int64)(L, K)
    if got < 0:
        raise RuntimeError("flda_estep: cannot query the device's shared memory")
    return got


def flda_estep(logbetaT, kappa, terms, counts, doc_mask, alpha, eta,
               gamma, El, El_old, tau, tau_old, *, viter: int, vtol: float,
               elogtheta_f64: bool = False):
    """Run the fLDA E-step over a chunk of documents (arguments: module
    doc).  CPU tensors take :func:`flda_estep_ref`; CUDA tensors launch
    the kernel (f32 only; ``elogtheta_f64`` selects its f64-channel mode)
    or raise."""
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
    f32 = torch.float32
    require("flda_estep", logbetaT.device, {
        "logbetaT": (logbetaT, (V, K), f32), "kappa": (kappa, (V,), f32),
        "terms": (terms, (B, L), torch.int32), "counts": (counts, (B, L), f32),
        "doc_mask": (doc_mask, (B,), f32), "alpha": (alpha, (K,), f32),
        "eta": (eta, (), f32), "gamma": (gamma, (B, K), f32),
        "El": (El, (B, K), f32), "El_old": (El_old, (B, K), f32),
        "tau": (tau, (B, L), f32), "tau_old": (tau_old, (B, L), f32)})
    outs = [torch.empty_like(gamma) for _ in range(3)]
    taus = [torch.empty_like(tau) for _ in range(2)]
    w = torch.empty((B, L, K + 1), dtype=f32, device=logbetaT.device)
    if B == 0:
        return (*outs, *taus, w)
    n_scratch = _scratch_floats(L, K)
    scratch = (torch.empty((B, n_scratch), dtype=f32, device=logbetaT.device)
               if n_scratch else None)
    err = _build.launch(
        _build.function("tmvb_flda_estep", _ARGTYPES), logbetaT.device,
        *(t.data_ptr() for t in (logbetaT, kappa, terms, counts, doc_mask, alpha, eta, gamma,
                                 El, El_old, tau, tau_old, *outs, *taus, w)),
        None if scratch is None else scratch.data_ptr(), B, L, K, int(viter), float(vtol),
        int(K % 4 == 0 and logbetaT.data_ptr() % 16 == 0), int(bool(elogtheta_f64)))
    check(err, "flda_estep")
    flda_estep.launches += 1
    flda_estep.launches_f64 += bool(elogtheta_f64)
    return (*outs, *taus, w)


flda_estep.launches = 0   # kernel launches (the plain version is not counted)
flda_estep.launches_f64 = 0   # of them, launches of the f64-channel mode
