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

On the card both run in the table's dtype: float32, or float64 (every
float argument float64; ψ the double series through t⁻¹², since the plain
versions take ψ from ``torch.special``), and at any K: where the chain
matrix A no longer fits shared memory (past 256 topics, or from K = 240
in float32 and ~170 in float64 on an H100) the kernels run their wide
mode, which keeps A, Aᵀ, S and the messages of each document in a device
scratch (:func:`mode`; ``3 K² + (L + 5) K + L`` elements a document for
:func:`hmtm_estep`, ``K² + 3 K`` for :func:`hmtm_logz`).  A wrapper raises,
with the byte count, when the device cannot hold that scratch; it never
hands the work to the plain version.
"""

from __future__ import annotations

import ctypes
import functools

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


def _shape(what, betaT_eps, terms, tmask):
    if betaT_eps.dim() != 2 or terms.dim() != 2:
        raise ValueError(f"{what}: terms and betaT_eps must be 2-D")
    B, L = terms.shape
    V, K = betaT_eps.shape
    if L < 1:
        raise ValueError(f"{what}: documents need at least one slot (L = 0)")
    if K < 1:
        raise ValueError(f"{what}: the table needs at least one topic (K = 0)")
    return B, L, V, K


# each mode's entry points, their scalar types and the suffix of their
# shape queries: float32, and float64 on a float64 state
_MODES = {torch.float32: ("", ctypes.c_float), torch.float64: ("_f64", ctypes.c_double)}


def _mode_of(what, dt):
    if dt not in _MODES:
        raise TypeError(f"{what}: betaT_eps must be torch.float32 or torch.float64, got {dt}")
    return _MODES[dt]


def _query(name: str, suffix: str, L: int, K: int) -> int:
    got = _build.function(f"tmvb_{name}{suffix}", [ctypes.c_int64] * 2, ctypes.c_int64)(L, K)
    if got < 0:
        raise RuntimeError(f"{name}: cannot query the device's shared memory")
    return got


WIDE = 3   # mode() of the wide mode


@functools.lru_cache(maxsize=None)
def mode(L: int, K: int, dtype=torch.float32) -> int:
    """The kernels' layout for documents of L slots at K topics: 0, 1 or 2
    (A in shared memory; the messages, then S too, in device scratch past
    what fits), or 3, the wide mode (A, Aᵀ, S and the messages in device
    scratch), taken past 256 topics or where A [K, K | 1] overflows the
    opt-in shared memory (K = 240 in float32 on an H100, ~170 in
    float64)."""
    fn = _build.function(f"tmvb_hmtm_estep_mode{_mode_of('hmtm', dtype)[0]}",
                         [ctypes.c_int64] * 2)
    got = fn(L, K)
    if got < 0:
        raise RuntimeError("hmtm_estep: cannot query the device's shared memory")
    return got


def _scratch(what: str, n: int, B: int, dt, device):
    """[B, n] device scratch, or None for n = 0; raises with the byte count
    when the device cannot hold it."""
    if n == 0:
        return None
    try:
        return torch.empty((B, n), dtype=dt, device=device)
    except torch.cuda.OutOfMemoryError as e:
        nbytes = B * n * torch.empty((), dtype=dt).element_size()
        raise RuntimeError(f"{what}: the device scratch of {B} x {n} elements ({nbytes} bytes) "
                           f"cannot be allocated: {e}") from None


def _estep_args(scalar):
    return [ctypes.c_void_p] * 12 + [ctypes.c_int64] * 3 + [ctypes.c_int, scalar,
                                                             ctypes.c_void_p]


_LOGZ_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_int64] * 3 + [ctypes.c_void_p]


def hmtm_estep(betaT_eps, terms, tmask, doc_mask, eta, alpha, tau, gamma,
               *, viter: int, vtol: float):
    """Run HMTM's E-step over a chunk of documents (arguments: module doc).

    CPU tensors take :func:`hmtm_estep_ref`; CUDA tensors launch the
    kernel or raise: its float32 mode, or on a float64 table its float64
    mode (every float argument float64); any K, past the shared-memory
    modes in the wide mode (:func:`mode`)."""
    if betaT_eps.device.type == "cpu":
        return hmtm_estep_ref(betaT_eps, terms, tmask, doc_mask, eta, alpha, tau, gamma,
                              viter=viter, vtol=vtol)
    if betaT_eps.device.type != "cuda":
        raise ValueError(f"hmtm_estep: no kernel for device {betaT_eps.device}")
    B, L, V, K = _shape("hmtm_estep", betaT_eps, terms, tmask)
    dt = betaT_eps.dtype
    suffix, scalar = _mode_of("hmtm_estep", dt)
    require("hmtm_estep", betaT_eps.device, {
        "betaT_eps": (betaT_eps, (V, K), dt), "terms": (terms, (B, L), torch.int32),
        "tmask": (tmask, (B, L), dt), "doc_mask": (doc_mask, (B,), dt),
        "eta": (eta, (K,), dt), "alpha": (alpha, (K, K), dt),
        "tau": (tau, (B, K), dt), "gamma": (gamma, (B, K, K), dt)})
    tau_out, gamma_out = torch.empty_like(tau), torch.empty_like(gamma)
    r = torch.empty((B, L, K), dtype=dt, device=betaT_eps.device)
    n_scratch = _query("hmtm_estep_scratch", suffix, L, K)
    if B == 0:
        return tau_out, gamma_out, r
    scratch = _scratch("hmtm_estep", n_scratch, B, dt, betaT_eps.device)
    err = _build.launch(
        _build.function(f"tmvb_hmtm_estep{suffix}", _estep_args(scalar)), betaT_eps.device,
        *(t.data_ptr() for t in (betaT_eps, terms, tmask, doc_mask, eta, alpha, tau, gamma,
                                 tau_out, gamma_out, r)),
        None if scratch is None else scratch.data_ptr(), B, L, K, int(viter), float(vtol))
    check(err, "hmtm_estep")
    hmtm_estep.launches += 1
    hmtm_estep.launches_double += dt == torch.float64
    hmtm_estep.launches_wide += mode(L, K, dt) == WIDE
    return tau_out, gamma_out, r


def hmtm_logz(betaT_eps, terms, tmask, tau, gamma):
    """Forward log-normaliser of each document's chain (arguments: module
    doc).  CPU tensors take :func:`hmtm_logz_ref`; CUDA tensors launch the
    kernel, in the table's dtype and at any K as :func:`hmtm_estep`, or
    raise."""
    if betaT_eps.device.type == "cpu":
        return hmtm_logz_ref(betaT_eps, terms, tmask, tau, gamma)
    if betaT_eps.device.type != "cuda":
        raise ValueError(f"hmtm_logz: no kernel for device {betaT_eps.device}")
    B, L, V, K = _shape("hmtm_logz", betaT_eps, terms, tmask)
    dt = betaT_eps.dtype
    suffix, _ = _mode_of("hmtm_logz", dt)
    require("hmtm_logz", betaT_eps.device, {
        "betaT_eps": (betaT_eps, (V, K), dt), "terms": (terms, (B, L), torch.int32),
        "tmask": (tmask, (B, L), dt), "tau": (tau, (B, K), dt),
        "gamma": (gamma, (B, K, K), dt)})
    n_scratch = _query("hmtm_logz_scratch", suffix, L, K)
    logz = torch.empty((B,), dtype=dt, device=betaT_eps.device)
    if B == 0:
        return logz
    scratch = _scratch("hmtm_logz", n_scratch, B, dt, betaT_eps.device)
    err = _build.launch(
        _build.function(f"tmvb_hmtm_logz{suffix}", _LOGZ_ARGS), betaT_eps.device,
        *(t.data_ptr() for t in (betaT_eps, terms, tmask, tau, gamma, logz)),
        None if scratch is None else scratch.data_ptr(), B, L, K)
    check(err, "hmtm_logz")
    hmtm_logz.launches += 1
    hmtm_logz.launches_double += dt == torch.float64
    hmtm_logz.launches_wide += n_scratch > 0
    return logz

hmtm_estep.launches = 0   # kernel launches (the plain version is not counted)
hmtm_estep.launches_double = 0   # of them, launches of the float64 mode
hmtm_estep.launches_wide = 0   # of them, launches of the wide mode (either dtype)
hmtm_logz.launches = 0
hmtm_logz.launches_double = 0
hmtm_logz.launches_wide = 0
