"""HMTM E-step and forward normaliser: the CUDA kernels' wrappers and their
plain PyTorch versions.

The kernels (``csrc/hmtm_estep.cu``) replace no Pallas kernel: the JAX
package runs HMTM's scaled forward-backward as ``lax.scan``s over the
token axis under ``jit`` (``models/hmtm.py:127-264``), and a scan is a
Python loop of ~20 launches a position in PyTorch.  Both versions take

  betaT_eps: [V, K]  (beta + EPSILON)ᵀ; each document's emission rows are
                     gathered by ``terms`` inside the function
  terms:     [B, L]  int32 0-based vocab ids, in token order
  tmask:     [B, L]  1 on real tokens, 0 on padding

:func:`hmtm_estep` also takes ``doc_mask [B]``, ``eta [K]``, ``alpha
[K, K]`` (column l the prior on theta[:, l]) and the per-document state
``tau [B, K]``, ``gamma [B, K, K]``, runs up to ``viter`` passes of the
chain fixpoint (a document stops once ‖Δgamma‖_F < vtol; a document with
``doc_mask = 0`` runs none) and returns ``(tau, gamma, r)`` with ``r [B,
L, K] = q(z_n)`` from one more forward-backward at the final state, on
every row.  :func:`hmtm_logz` takes ``tau``, ``gamma`` and returns the
forward log-normaliser ``logZ [B]``.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils.numerics import EPSILON, digamma, l2norm, masked_fixpoint
from . import _build
from ._build import check, require


def _tilde(tau, gamma):
    """p0 = exp(E[log pi]) [B, K] and A = exp(E[log theta]) [B, K, K]
    (JAX ``_tilde``): both in (0, 1], so the scaled linear-space
    recursions cannot overflow."""
    Elogpi = digamma(tau) - digamma(torch.sum(tau, -1, keepdim=True))
    Elogth = digamma(gamma) - digamma(torch.sum(gamma, -2, keepdim=True))
    return torch.exp(Elogpi), torch.exp(Elogth)


def _forward(p0, A, Bv, tmask):
    """Scaled forward pass (JAX ``_forward``): messages a [B, L, K],
    effective scalers c [B, L] (1 on padding) and logZ [B]."""
    m0 = tmask[:, 0] > 0
    f0 = torch.where(m0[:, None], p0 * Bv[:, 0], p0)
    c0 = torch.sum(f0, -1) + EPSILON
    a_prev = f0 / c0[:, None]
    logZ = torch.where(m0, torch.log(c0), torch.zeros_like(c0))
    a, c = [a_prev], [torch.where(m0, c0, torch.ones_like(c0))]
    for n in range(1, Bv.shape[1]):
        f = Bv[:, n] * torch.einsum("bil,bl->bi", A, a_prev)
        cn = torch.sum(f, -1) + EPSILON
        upd = tmask[:, n] > 0
        a_prev = torch.where(upd[:, None], f / cn[:, None], a_prev)
        c_eff = torch.where(upd, cn, torch.ones_like(cn))
        logZ = logZ + torch.log(c_eff)
        a.append(a_prev)
        c.append(c_eff)
    return torch.stack(a, 1), torch.stack(c, 1), logZ


def _backward(a, c, A, Bv, tmask, with_r: bool):
    """Scaled backward pass with the statistics (JAX ``_backward_stats``):
    r0 [B, K], xi_sum [B, K, K] = Σ_{n≥2} q(z_n, z_{n-1}) and, with
    ``with_r``, r [B, L, K]; padding slots contribute exact zeros."""
    B, L, K = Bv.shape
    be = torch.ones((B, K), dtype=Bv.dtype, device=Bv.device)
    xi = torch.zeros((B, K, K), dtype=Bv.dtype, device=Bv.device)
    r = [None] * L
    for n in range(L - 1, 0, -1):
        upd = tmask[:, n] > 0
        g = (Bv[:, n] * be) / c[:, n, None]
        xi_n = A * g[:, :, None] * a[:, n - 1, None, :]
        xi = xi + torch.where(upd[:, None, None], xi_n, torch.zeros_like(xi_n))
        if with_r:
            r[n] = torch.where(upd[:, None], a[:, n] * be, torch.zeros_like(be))
        be = torch.where(upd[:, None], torch.einsum("bil,bi->bl", A, g), be)
    r0 = a[:, 0] * be * tmask[:, 0, None]
    if not with_r:
        return r0, xi, None
    r[0] = r0
    return r0, xi, torch.stack(r, 1)


def hmtm_estep_ref(betaT_eps, terms, tmask, doc_mask, eta, alpha, tau, gamma,
                   *, viter: int, vtol: float):
    """Plain PyTorch version of :func:`hmtm_estep` (JAX ``_estep_chunk``
    less its scatter): the chunk's documents run the fixpoint together,
    each frozen once it converges."""
    Bv = betaT_eps[terms]                                  # [B, L, K]

    def body(_, carry):
        tau, gamma, active = carry
        p0, A = _tilde(tau, gamma)
        a, c, _ = _forward(p0, A, Bv, tmask)
        r0, xi_sum, _ = _backward(a, c, A, Bv, tmask, with_r=False)
        tau_new = eta[None, :] + r0
        gamma_new = alpha[None, :, :] + xi_sum
        delta = l2norm((gamma_new - gamma).reshape(gamma.shape[0], -1))
        upd = active[:, None]
        return (torch.where(upd, tau_new, tau), torch.where(upd[..., None], gamma_new, gamma),
                active & (delta >= vtol))

    tau, gamma, _ = masked_fixpoint(body, (tau, gamma, doc_mask > 0), viter)
    p0, A = _tilde(tau, gamma)
    a, c, _ = _forward(p0, A, Bv, tmask)
    _, _, r = _backward(a, c, A, Bv, tmask, with_r=True)
    return tau, gamma, r


def hmtm_logz_ref(betaT_eps, terms, tmask, tau, gamma):
    """Plain PyTorch version of :func:`hmtm_logz` (JAX ``_forward``'s
    third output)."""
    p0, A = _tilde(tau, gamma)
    return _forward(p0, A, betaT_eps[terms], tmask)[2]


_TOO_WIDE = "the device's shared memory holds the [K, K | 1] chain matrix up to K = 239 on an H100"


def _shape(what, betaT_eps, terms, tmask):
    if betaT_eps.dim() != 2 or terms.dim() != 2:
        raise ValueError(f"{what}: terms and betaT_eps must be 2-D")
    B, L = terms.shape
    V, K = betaT_eps.shape
    if L < 1:
        raise ValueError(f"{what}: documents need at least one slot (L = 0)")
    return B, L, V, K


def _scratch_floats(L: int, K: int) -> int:
    """Floats of device scratch one document of L slots needs: 0 when its
    messages fit shared memory (the NSF widths at K = 25)."""
    got = _build.function("tmvb_hmtm_estep_scratch", [ctypes.c_int64] * 2, ctypes.c_int64)(L, K)
    if got == -2:
        raise ValueError(f"hmtm_estep: K = {K} topics do not fit: {_TOO_WIDE}")
    if got < 0:
        raise RuntimeError("hmtm_estep: cannot query the device's shared memory")
    return got


_ESTEP_ARGS = [ctypes.c_void_p] * 12 + [ctypes.c_int64] * 3 + [
    ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
_LOGZ_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int64] * 3 + [ctypes.c_void_p]


def hmtm_estep(betaT_eps, terms, tmask, doc_mask, eta, alpha, tau, gamma,
               *, viter: int, vtol: float):
    """Run HMTM's E-step over a chunk of documents (arguments: module doc).

    CPU tensors take :func:`hmtm_estep_ref`; CUDA tensors launch the
    kernel (f32 only) or raise."""
    if betaT_eps.device.type == "cpu":
        return hmtm_estep_ref(betaT_eps, terms, tmask, doc_mask, eta, alpha, tau, gamma,
                              viter=viter, vtol=vtol)
    if betaT_eps.device.type != "cuda":
        raise ValueError(f"hmtm_estep: no kernel for device {betaT_eps.device}")
    B, L, V, K = _shape("hmtm_estep", betaT_eps, terms, tmask)
    f32 = torch.float32
    require("hmtm_estep", betaT_eps.device, {
        "betaT_eps": (betaT_eps, (V, K), f32), "terms": (terms, (B, L), torch.int32),
        "tmask": (tmask, (B, L), f32), "doc_mask": (doc_mask, (B,), f32),
        "eta": (eta, (K,), f32), "alpha": (alpha, (K, K), f32),
        "tau": (tau, (B, K), f32), "gamma": (gamma, (B, K, K), f32)})
    tau_out, gamma_out = torch.empty_like(tau), torch.empty_like(gamma)
    r = torch.empty((B, L, K), dtype=f32, device=betaT_eps.device)
    n_scratch = _scratch_floats(L, K)
    if B == 0:
        return tau_out, gamma_out, r
    scratch = (torch.empty((B, n_scratch), dtype=f32, device=betaT_eps.device)
               if n_scratch else None)
    err = _build.launch(
        _build.function("tmvb_hmtm_estep", _ESTEP_ARGS), betaT_eps.device,
        *(t.data_ptr() for t in (betaT_eps, terms, tmask, doc_mask, eta, alpha, tau, gamma,
                                 tau_out, gamma_out, r)),
        None if scratch is None else scratch.data_ptr(), B, L, K, int(viter), float(vtol))
    check(err, "hmtm_estep")
    hmtm_estep.launches += 1
    return tau_out, gamma_out, r


def hmtm_logz(betaT_eps, terms, tmask, tau, gamma):
    """Forward log-normaliser of each document's chain (arguments: module
    doc).  CPU tensors take :func:`hmtm_logz_ref`; CUDA tensors launch the
    kernel (f32 only) or raise."""
    if betaT_eps.device.type == "cpu":
        return hmtm_logz_ref(betaT_eps, terms, tmask, tau, gamma)
    if betaT_eps.device.type != "cuda":
        raise ValueError(f"hmtm_logz: no kernel for device {betaT_eps.device}")
    B, L, V, K = _shape("hmtm_logz", betaT_eps, terms, tmask)
    f32 = torch.float32
    require("hmtm_logz", betaT_eps.device, {
        "betaT_eps": (betaT_eps, (V, K), f32), "terms": (terms, (B, L), torch.int32),
        "tmask": (tmask, (B, L), f32), "tau": (tau, (B, K), f32),
        "gamma": (gamma, (B, K, K), f32)})
    if _build.function("tmvb_hmtm_estep_mode", [ctypes.c_int64] * 2)(L, K) == -2:
        raise ValueError(f"hmtm_logz: K = {K} topics do not fit: {_TOO_WIDE}")
    logz = torch.empty((B,), dtype=f32, device=betaT_eps.device)
    if B == 0:
        return logz
    err = _build.launch(
        _build.function("tmvb_hmtm_logz", _LOGZ_ARGS), betaT_eps.device,
        *(t.data_ptr() for t in (betaT_eps, terms, tmask, tau, gamma, logz)), B, L, K)
    check(err, "hmtm_logz")
    hmtm_logz.launches += 1
    return logz


hmtm_estep.launches = 0   # kernel launches (the plain version is not counted)
hmtm_logz.launches = 0
