"""LDA ELBO token terms: the CUDA kernel's wrapper and its plain version.

The kernel (``csrc/lda_elbo.cu``) replaces the JAX package's Pallas
kernel ``lda_elbo_tok``; it has a float32 and a float64 mode, picked by
the tables' dtype.  Both versions here take

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


_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int64] * 3 + [ctypes.c_int, ctypes.c_void_p]


def _vec(K: int, *tables) -> int:
    """Width of the kernel's row loads in elements: 4 floats where K % 4 ==
    0 and every table is 16-byte aligned, 2 where K % 2 == 0 and 8-byte
    aligned, else 1; for doubles, 2 where K % 2 == 0 and 16-byte aligned,
    else 1 (16 bytes at most)."""
    size = tables[0].element_size()
    for v in (4, 2):
        if v * size <= 16 and K % v == 0 and all(t.data_ptr() % (size * v) == 0
                                                 for t in tables):
            return v
    return 1


def lda_elbo_tok(boT, g2T, terms, counts, doc_mask, El, El_old):
    """Token-level ELBO terms summed over a chunk of documents.

    CPU tensors take :func:`lda_elbo_tok_ref`; CUDA tensors launch the
    kernel, in its float32 or float64 mode as ``boT``'s dtype says (every
    float argument of that dtype), or raise.  The kernel writes one
    partial per document and the partials are summed here, so the result
    is bitwise reproducible."""
    if boT.device.type == "cpu":
        return lda_elbo_tok_ref(boT, g2T, terms, counts, doc_mask, El, El_old)
    if boT.device.type != "cuda":
        raise ValueError(f"lda_elbo_tok: no kernel for device {boT.device}")
    if terms.dim() != 2 or boT.dim() != 2:
        raise ValueError("lda_elbo_tok: terms and boT must be 2-D")
    B, L = terms.shape
    V, K = boT.shape
    dt = boT.dtype
    if dt not in _ENTRY:
        raise TypeError(f"lda_elbo_tok: boT must be torch.float32 or torch.float64, got {dt}")
    require("lda_elbo_tok", boT.device, {
        "boT": (boT, (V, K), dt), "g2T": (g2T, (V, K), dt),
        "terms": (terms, (B, L), torch.int32),
        "counts": (counts, (B, L), dt), "doc_mask": (doc_mask, (B,), dt),
        "El": (El, (B, K), dt), "El_old": (El_old, (B, K), dt)})
    out = torch.empty((B,), dtype=dt, device=boT.device)
    if B == 0:
        return torch.sum(out)
    err = _build.launch(
        _build.function(_ENTRY[dt], _ARGTYPES), boT.device,
        *(t.data_ptr() for t in (boT, g2T, terms, counts, doc_mask, El, El_old, out)),
        B, L, K, _vec(K, boT, g2T))
    check(err, "lda_elbo_tok")
    lda_elbo_tok.launches += 1
    lda_elbo_tok.launches_double += dt == torch.float64
    return torch.sum(out)


# the C entry point of each mode
_ENTRY = {torch.float32: "tmvb_lda_elbo_tok", torch.float64: "tmvb_lda_elbo_tok_f64"}
lda_elbo_tok.launches = 0   # kernel launches (the plain version is not counted)
lda_elbo_tok.launches_double = 0   # of them, launches of the float64 mode
