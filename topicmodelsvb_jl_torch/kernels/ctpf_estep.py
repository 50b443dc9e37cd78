"""CTPF E-step: the CUDA kernel's wrapper and its plain PyTorch version.

The kernel (``csrc/ctpf_estep.cu``) replaces the JAX package's Pallas
kernel ``ctpf_estep``.  Both versions here take the same arguments:

  ealefT:   [V, K]  exp(ψ(alef))ᵀ;  eheT: [U, K]  exp(ψ(he))ᵀ — each
                    document's rows are gathered by ``terms``/``readers``
                    inside the function
  terms:    [B, L]  int32 0-based vocab ids;  counts: [B, L], 0 on padding
  readers:  [B, R]  int32 0-based user ids;   ratings: [B, R], 0 on padding
  doc_mask: [B]     1 for real documents
  inv_db, inv_dv, inv_hv: [K]  1/(dalet·bet), 1/(dalet·vav), 1/(het·vav)
  gimel, gimel_old, zayin, zayin_old: [B, K] per-document state

and return ``(gimel, gimel_old, zayin, zayin_old, wa, wh)`` with
``wa = phi·counts`` [B, L, K] and ``wh = (xi_top + xi_bot)·ratings``
[B, R, K], phi and xi taken from the final ``gimel_old``/``zayin_old``
(CTPF.jl:259-277).  A document with ``doc_mask = 0`` keeps its state.

phi and xi are formed multiplicatively (CTPF.jl:327-338):
phi ∝ exp(ψ(alef))[:, terms]·exp(ψ(gimel))/(dalet·bet) and the 2K xi
shares one normaliser over exp(ψ(he))[:, readers]·(exp(ψ(gimel))/(dalet·vav)
+ exp(ψ(zayin))/(het·vav)); both normalisers carry the ``+ EPSILON``
guard of the TPU kernel.  ψ is the kernels' shift-by-8 series.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..utils.numerics import EPSILON, masked_fixpoint
from . import _build
from ._build import check, require
from .lda_estep import digamma_series


def _factors(gimel, zayin, inv_db, inv_dv, inv_hv):
    eg = torch.exp(digamma_series(gimel))
    ez = torch.exp(digamma_series(zayin))
    return eg * inv_db, eg * inv_dv, ez * inv_hv


def ctpf_estep_ref(ealefT, eheT, terms, counts, readers, ratings, doc_mask,
                   inv_db, inv_dv, inv_hv, gimel, gimel_old, zayin, zayin_old,
                   *, viter: int, vtol: float, c_hyper: float, g_hyper: float):
    """Plain PyTorch version of the kernel: the batch of documents runs
    the fixpoint together, each document frozen once it converges."""
    ea = ealefT[terms]                                 # [B, L, K]
    eh = eheT[readers]                                 # [B, R, K]
    vtol2 = vtol * vtol

    def normalised(qp, qs):
        cs = counts / (torch.sum(ea * qp[:, None, :], dim=-1) + EPSILON)
        rs = ratings / (torch.sum(eh * qs[:, None, :], dim=-1) + EPSILON)
        return cs, rs

    def body(_, carry):
        gi, gio, za, zao, active = carry
        qp, qt, qb = _factors(gi, za, inv_db, inv_dv, inv_hv)
        cs, rs = normalised(qp, qt + qb)
        pc = qp * torch.sum(ea * cs[:, :, None], dim=1)
        hr = torch.sum(eh * rs[:, :, None], dim=1)
        gi_new = c_hyper + pc + qt * hr
        za_new = g_hyper + qb * hr
        upd = active[:, None]
        gio2 = torch.where(upd, gi, gio)
        gi2 = torch.where(upd, gi_new, gi)
        zao2 = torch.where(upd, za, zao)
        za2 = torch.where(upd, za_new, za)
        d = gi2 - gio2
        return gi2, gio2, za2, zao2, active & (torch.sum(d * d, -1) >= vtol2)

    gimel, gimel_old, zayin, zayin_old, _ = masked_fixpoint(
        body, (gimel, gimel_old, zayin, zayin_old, doc_mask > 0), viter)
    qp, qt, qb = _factors(gimel_old, zayin_old, inv_db, inv_dv, inv_hv)
    qs = qt + qb
    cs, rs = normalised(qp, qs)
    wa = ea * (qp[:, None, :] * cs[:, :, None])
    wh = eh * (qs[:, None, :] * rs[:, :, None])
    return gimel, gimel_old, zayin, zayin_old, wa, wh


_ARGTYPES = [ctypes.c_void_p] * 21 + [ctypes.c_int64] * 4 + [
    ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_void_p]


@functools.lru_cache(maxsize=None)
def _scratch_floats(L: int, R: int, K: int) -> int:
    """Floats of device scratch one document of L token and R reader slots
    needs: 0 when its slot list fits shared memory (the main path's
    widths)."""
    got = _build.function("tmvb_ctpf_estep_scratch", [ctypes.c_int64] * 3,
                          ctypes.c_int64)(L, R, K)
    if got < 0:
        raise RuntimeError("ctpf_estep: cannot query the device's shared memory")
    return got


def ctpf_estep(ealefT, eheT, terms, counts, readers, ratings, doc_mask,
               inv_db, inv_dv, inv_hv, gimel, gimel_old, zayin, zayin_old,
               *, viter: int, vtol: float, c_hyper: float, g_hyper: float):
    """Run the CTPF E-step over a chunk of documents (arguments: module
    doc).  CPU tensors take :func:`ctpf_estep_ref`; CUDA tensors launch
    the kernel (f32 only) or raise."""
    kw = dict(viter=viter, vtol=vtol, c_hyper=c_hyper, g_hyper=g_hyper)
    if ealefT.device.type == "cpu":
        return ctpf_estep_ref(ealefT, eheT, terms, counts, readers, ratings, doc_mask,
                              inv_db, inv_dv, inv_hv, gimel, gimel_old, zayin,
                              zayin_old, **kw)
    if ealefT.device.type != "cuda":
        raise ValueError(f"ctpf_estep: no kernel for device {ealefT.device}")
    if terms.dim() != 2 or readers.dim() != 2 or ealefT.dim() != 2 or eheT.dim() != 2:
        raise ValueError("ctpf_estep: terms, readers and the tables must be 2-D")
    B, L = terms.shape
    R = readers.shape[1]
    V, K = ealefT.shape
    U = eheT.shape[0]
    f32, i32 = torch.float32, torch.int32
    require("ctpf_estep", ealefT.device, {
        "ealefT": (ealefT, (V, K), f32), "eheT": (eheT, (U, K), f32),
        "terms": (terms, (B, L), i32), "counts": (counts, (B, L), f32),
        "readers": (readers, (B, R), i32), "ratings": (ratings, (B, R), f32),
        "doc_mask": (doc_mask, (B,), f32), "inv_db": (inv_db, (K,), f32),
        "inv_dv": (inv_dv, (K,), f32), "inv_hv": (inv_hv, (K,), f32),
        "gimel": (gimel, (B, K), f32), "gimel_old": (gimel_old, (B, K), f32),
        "zayin": (zayin, (B, K), f32), "zayin_old": (zayin_old, (B, K), f32)})
    outs = [torch.empty_like(gimel) for _ in range(4)]
    wa = torch.empty((B, L, K), dtype=f32, device=ealefT.device)
    wh = torch.empty((B, R, K), dtype=f32, device=ealefT.device)
    if B == 0:
        return (*outs, wa, wh)
    n_scratch = _scratch_floats(L, R, K)
    scratch = (torch.empty((B, n_scratch), dtype=f32, device=ealefT.device)
               if n_scratch else None)
    err = _build.launch(
        _build.function("tmvb_ctpf_estep", _ARGTYPES), ealefT.device,
        *(t.data_ptr() for t in (ealefT, eheT, terms, counts, readers, ratings, doc_mask,
                                 inv_db, inv_dv, inv_hv, gimel, gimel_old, zayin, zayin_old,
                                 *outs, wa, wh)),
        None if scratch is None else scratch.data_ptr(),
        B, L, R, K, int(viter), float(vtol), float(c_hyper), float(g_hyper))
    check(err, "ctpf_estep")
    ctpf_estep.launches += 1
    return (*outs, wa, wh)


ctpf_estep.launches = 0   # kernel launches (the plain version is not counted)
