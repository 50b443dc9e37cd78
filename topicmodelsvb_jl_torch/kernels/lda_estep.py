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

phi is computed multiplicatively — ``phi ∝ (beta+eps)[:, terms]·exp(El)``
— exactly the CPU reference's update (LDA.jl:150-154 under @positive),
and ψ is the shift-by-8 asymptotic series of the reference's OpenCL
``DIGAMMA_c`` (utils.jl:21-53).
"""

from __future__ import annotations

import ctypes

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


def lda_estep_ref(betaT, terms, counts, doc_mask, alpha, gamma, El, El_old,
                  *, viter: int, vtol: float):
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
        El_new = (digamma_series(gamma_new)
                  - digamma_series(torch.sum(gamma_new, -1, keepdim=True)))
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


_ARGTYPES = [ctypes.c_void_p] * 13 + [ctypes.c_int64] * 3 + [
    ctypes.c_int, ctypes.c_float, ctypes.c_void_p]


def lda_estep(betaT, terms, counts, doc_mask, alpha, gamma, El, El_old,
              *, viter: int, vtol: float):
    """Run the E-step over a chunk of documents (arguments: module doc).

    CPU tensors take :func:`lda_estep_ref`; CUDA tensors launch the
    kernel (f32 only) or raise."""
    if betaT.device.type == "cpu":
        return lda_estep_ref(betaT, terms, counts, doc_mask, alpha, gamma,
                             El, El_old, viter=viter, vtol=vtol)
    if betaT.device.type != "cuda":
        raise ValueError(f"lda_estep: no kernel for device {betaT.device}")
    if terms.dim() != 2 or betaT.dim() != 2:
        raise ValueError("lda_estep: terms and betaT must be 2-D")
    B, L = terms.shape
    V, K = betaT.shape
    f32 = torch.float32
    require("lda_estep", betaT.device, {
        "betaT": (betaT, (V, K), f32), "terms": (terms, (B, L), torch.int32),
        "counts": (counts, (B, L), f32), "doc_mask": (doc_mask, (B,), f32),
        "alpha": (alpha, (K,), f32), "gamma": (gamma, (B, K), f32),
        "El": (El, (B, K), f32), "El_old": (El_old, (B, K), f32)})
    outs = [torch.empty_like(gamma) for _ in range(3)]
    w = torch.empty((B, L, K), dtype=torch.float32, device=betaT.device)
    if B == 0:
        return (*outs, w)
    scratch = torch.empty((B, L), dtype=torch.float32, device=betaT.device)
    fn = _build.function("tmvb_lda_estep", _ARGTYPES)
    with torch.cuda.device(betaT.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*(t.data_ptr() for t in (
            betaT, terms, counts, doc_mask, alpha, gamma, El, El_old,
            *outs, w, scratch)), B, L, K, int(viter), float(vtol), stream)
    check(err, "lda_estep")
    lda_estep.launches += 1
    return (*outs, w)


lda_estep.launches = 0   # kernel launches (the plain version is not counted)
