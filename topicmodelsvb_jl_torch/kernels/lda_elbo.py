"""LDA ELBO token terms: the CUDA kernel's wrapper and its plain version.

The kernel (``csrc/lda_elbo.cu``) replaces the JAX package's Pallas
kernel ``lda_elbo_tok``.  Both versions here take

  boT:   [V, K]  (beta_old + EPSILON)ᵀ
  g2T:   [V, K]  boT · (log(beta + EPSILON) − log(beta_old + EPSILON))ᵀ
  terms: [B, L]  int32; counts: [B, L]; doc_mask: [B]
  El, El_old: [B, K] current / old Elogtheta

and return the 0-dim sum over documents of Elogpz + Elogpw − Elogqz
(LDA.jl:56-80), with phi recomputed from (beta_old, El_old).  With
Σ_k phi = 1 and phi = bo·e/s (e = exp(El_old), s_l = Σ_k bo_lk·e_k):

    Σ_k (e ⊙ q)_k·(El − El_old)_k + Σ_k e_k·a2_k + Σ_l c_l·log s_l,
    q_k = Σ_l (c/s)_l·bo_lk,   a2_k = Σ_l (c/s)_l·g2_lk,

where ``c/s`` and ``c·log s`` are 0 on slots with c = 0: a raw beta_old
without the EPSILON guard can give s = 0 there.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from ._build import check, require


def lda_elbo_tok_ref(boT, g2T, terms, counts, doc_mask, El, El_old):
    """Plain PyTorch version of the kernel."""
    bo = boT[terms]                                    # [B, L, K]
    g2 = g2T[terms]
    e = torch.exp(El_old)
    s = torch.sum(bo * e[:, None, :], dim=-1)          # [B, L]
    pos = counts > 0
    s_safe = torch.where(pos, s, torch.ones_like(s))
    r = torch.where(pos, counts / s_safe, torch.zeros_like(s))
    q = torch.sum(r[:, :, None] * bo, dim=1)           # [B, K]
    a2 = torch.sum(r[:, :, None] * g2, dim=1)
    per_doc = (torch.sum(e * q * (El - El_old), -1)
               + torch.sum(e * a2, -1)
               + torch.sum(torch.where(pos, counts * torch.log(s_safe),
                                       torch.zeros_like(s)), -1))
    return torch.sum(per_doc * doc_mask)


_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int64] * 3 + [ctypes.c_void_p]


def lda_elbo_tok(boT, g2T, terms, counts, doc_mask, El, El_old):
    """Token-level ELBO terms summed over a chunk of documents.

    CPU tensors take :func:`lda_elbo_tok_ref`; CUDA tensors launch the
    kernel (f32 only) or raise.  The kernel writes one partial per
    document and the partials are summed here, so the result is bitwise
    reproducible."""
    if boT.device.type == "cpu":
        return lda_elbo_tok_ref(boT, g2T, terms, counts, doc_mask, El, El_old)
    if boT.device.type != "cuda":
        raise ValueError(f"lda_elbo_tok: no kernel for device {boT.device}")
    if terms.dim() != 2 or boT.dim() != 2:
        raise ValueError("lda_elbo_tok: terms and boT must be 2-D")
    B, L = terms.shape
    V, K = boT.shape
    f32 = torch.float32
    require("lda_elbo_tok", boT.device, {
        "boT": (boT, (V, K), f32), "g2T": (g2T, (V, K), f32),
        "terms": (terms, (B, L), torch.int32),
        "counts": (counts, (B, L), f32), "doc_mask": (doc_mask, (B,), f32),
        "El": (El, (B, K), f32), "El_old": (El_old, (B, K), f32)})
    out = torch.empty((B,), dtype=torch.float32, device=boT.device)
    if B == 0:
        return torch.sum(out)
    scratch = torch.empty((B, L), dtype=torch.float32, device=boT.device)
    fn = _build.function("tmvb_lda_elbo_tok", _ARGTYPES)
    with torch.cuda.device(boT.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*(t.data_ptr() for t in (
            boT, g2T, terms, counts, doc_mask, El, El_old, out, scratch)),
            B, L, K, stream)
    check(err, "lda_elbo_tok")
    lda_elbo_tok.launches += 1
    return torch.sum(out)


lda_elbo_tok.launches = 0   # kernel launches (the plain version is not counted)
