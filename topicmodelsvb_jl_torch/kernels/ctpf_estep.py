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

:func:`ctpf_estep_pass` is the kernel's pass mode, for the sequence axis,
where each document's token and reader slots are split over ranks: one
pass's partial gimel and zayin statistics on this rank's slots; the
caller sums them over the ranks between passes, and
:func:`ctpf_split_fixpoint` drives it.

On a float64 state the kernel and its pass mode run their float64 modes:
the same fixpoint with every tensor in float64 and ψ the same shift-by-8
series in double, what :func:`ctpf_estep_ref` computes on that state.
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


def _normalised(ea, eh, counts, ratings, qp, qs):
    """The slots' weights over their normalisers on gathered rows: c / (ea·qp
    + EPSILON) [B, L] and y / (eh·qs + EPSILON) [B, R]."""
    cs = counts / (torch.sum(ea * qp[:, None, :], dim=-1) + EPSILON)
    rs = ratings / (torch.sum(eh * qs[:, None, :], dim=-1) + EPSILON)
    return cs, rs


def _pass(ea, eh, counts, ratings, gimel, zayin, inv_db, inv_dv, inv_hv):
    """One pass on gathered rows: gimel's statistic phi@counts +
    xi_top@ratings and zayin's xi_bot@ratings, both [B, K]."""
    qp, qt, qb = _factors(gimel, zayin, inv_db, inv_dv, inv_hv)
    cs, rs = _normalised(ea, eh, counts, ratings, qp, qt + qb)
    hr = torch.sum(eh * rs[:, :, None], dim=1)
    return qp * torch.sum(ea * cs[:, :, None], dim=1) + qt * hr, qb * hr


def _update(carry, gsum, zsum, c_hyper, g_hyper, vtol2):
    """The fixpoint's update on the [B, K] tiles from one pass's summed
    statistics: gimel, zayin, the masked state and the per-document stop
    test on gimel."""
    gi, gio, za, zao, active = carry
    upd = active[:, None]
    gio2 = torch.where(upd, gi, gio)
    gi2 = torch.where(upd, c_hyper + gsum, gi)
    zao2 = torch.where(upd, za, zao)
    za2 = torch.where(upd, g_hyper + zsum, za)
    d = gi2 - gio2
    return gi2, gio2, za2, zao2, active & (torch.sum(d * d, -1) >= vtol2)


def ctpf_estep_ref(ealefT, eheT, terms, counts, readers, ratings, doc_mask,
                   inv_db, inv_dv, inv_hv, gimel, gimel_old, zayin, zayin_old,
                   *, viter: int, vtol: float, c_hyper: float, g_hyper: float):
    """Plain PyTorch version of the kernel: the batch of documents runs
    the fixpoint together, each document frozen once it converges."""
    ea = ealefT[terms]                                 # [B, L, K]
    eh = eheT[readers]                                 # [B, R, K]
    vtol2 = vtol * vtol

    def body(_, carry):
        gsum, zsum = _pass(ea, eh, counts, ratings, carry[0], carry[2], inv_db, inv_dv, inv_hv)
        return _update(carry, gsum, zsum, c_hyper, g_hyper, vtol2)

    gimel, gimel_old, zayin, zayin_old, _ = masked_fixpoint(
        body, (gimel, gimel_old, zayin, zayin_old, doc_mask > 0), viter)
    qp, qt, qb = _factors(gimel_old, zayin_old, inv_db, inv_dv, inv_hv)
    qs = qt + qb
    cs, rs = _normalised(ea, eh, counts, ratings, qp, qs)
    wa = ea * (qp[:, None, :] * cs[:, :, None])
    wh = eh * (qs[:, None, :] * rs[:, :, None])
    return gimel, gimel_old, zayin, zayin_old, wa, wh


def _argtypes(scalar) -> list:
    return [ctypes.c_void_p] * 21 + [ctypes.c_int64] * 4 + [
        ctypes.c_int, scalar, scalar, scalar, ctypes.c_void_p]


# each mode's scalar type (vtol and the hyperparameters) and the suffix of
# its entry points: float32, and float64 on a float64 state
_MODES = {torch.float32: (ctypes.c_float, ""), torch.float64: (ctypes.c_double, "_f64")}


def _mode_of(what: str, dt):
    if dt not in _MODES:
        raise TypeError(f"{what}: ealefT must be torch.float32 or torch.float64, got {dt}")
    return _MODES[dt]


@functools.lru_cache(maxsize=None)
def _scratch_elems(L: int, R: int, K: int, suffix: str = "") -> int:
    """Elements of device scratch one document of L token and R reader
    slots needs: 0 when its slot list fits shared memory (the main path's
    widths)."""
    got = _build.function(f"tmvb_ctpf_estep_scratch{suffix}", [ctypes.c_int64] * 3,
                          ctypes.c_int64)(L, R, K)
    if got < 0:
        raise RuntimeError(f"ctpf_estep: K = {K} does not fit the device's shared memory "
                           f"{'in float64 ' if suffix else ''}(or it cannot be queried)")
    return got


def _chunk_specs(what, ealefT, eheT, terms, readers, dt, **state):
    """``require``'s specs of the chunk's tables, slots and [K] vectors
    (and of ``state``, each [B, K]), with (B, L, R, V, U, K)."""
    if terms.dim() != 2 or readers.dim() != 2 or ealefT.dim() != 2 or eheT.dim() != 2:
        raise ValueError(f"{what}: terms, readers and the tables must be 2-D")
    B, L = terms.shape
    R = readers.shape[1]
    V, K = ealefT.shape
    U = eheT.shape[0]
    return (B, L, R, K), {"ealefT": (ealefT, (V, K), dt), "eheT": (eheT, (U, K), dt),
                          "terms": (terms, (B, L), torch.int32),
                          "readers": (readers, (B, R), torch.int32),
                          **{n: (t, (B, K), dt) for n, t in state.items()}}


def ctpf_estep(ealefT, eheT, terms, counts, readers, ratings, doc_mask,
               inv_db, inv_dv, inv_hv, gimel, gimel_old, zayin, zayin_old,
               *, viter: int, vtol: float, c_hyper: float, g_hyper: float):
    """Run the CTPF E-step over a chunk of documents (arguments: module
    doc).  CPU tensors take :func:`ctpf_estep_ref`; CUDA tensors launch
    the kernel or raise: its float32 mode or, on float64 tables, its
    float64 mode (every float argument float64)."""
    kw = dict(viter=viter, vtol=vtol, c_hyper=c_hyper, g_hyper=g_hyper)
    if ealefT.device.type == "cpu":
        return ctpf_estep_ref(ealefT, eheT, terms, counts, readers, ratings, doc_mask,
                              inv_db, inv_dv, inv_hv, gimel, gimel_old, zayin,
                              zayin_old, **kw)
    if ealefT.device.type != "cuda":
        raise ValueError(f"ctpf_estep: no kernel for device {ealefT.device}")
    dt = ealefT.dtype
    scalar, suffix = _mode_of("ctpf_estep", dt)
    (B, L, R, K), specs = _chunk_specs("ctpf_estep", ealefT, eheT, terms, readers, dt,
                                       gimel=gimel, gimel_old=gimel_old, zayin=zayin,
                                       zayin_old=zayin_old)
    require("ctpf_estep", ealefT.device, {
        **specs, "counts": (counts, (B, L), dt), "ratings": (ratings, (B, R), dt),
        "doc_mask": (doc_mask, (B,), dt), "inv_db": (inv_db, (K,), dt),
        "inv_dv": (inv_dv, (K,), dt), "inv_hv": (inv_hv, (K,), dt)})
    outs = [torch.empty_like(gimel) for _ in range(4)]
    wa = torch.empty((B, L, K), dtype=dt, device=ealefT.device)
    wh = torch.empty((B, R, K), dtype=dt, device=ealefT.device)
    if B == 0:
        return (*outs, wa, wh)
    n_scratch = _scratch_elems(L, R, K, suffix)
    scratch = (torch.empty((B, n_scratch), dtype=dt, device=ealefT.device)
               if n_scratch else None)
    err = _build.launch(
        _build.function(f"tmvb_ctpf_estep{suffix}", _argtypes(scalar)), ealefT.device,
        *(t.data_ptr() for t in (ealefT, eheT, terms, counts, readers, ratings, doc_mask,
                                 inv_db, inv_dv, inv_hv, gimel, gimel_old, zayin, zayin_old,
                                 *outs, wa, wh)),
        None if scratch is None else scratch.data_ptr(),
        B, L, R, K, int(viter), float(vtol), float(c_hyper), float(g_hyper))
    check(err, "ctpf_estep")
    ctpf_estep.launches += 1
    ctpf_estep.launches_double += dt == torch.float64
    return (*outs, wa, wh)


ctpf_estep.launches = 0   # kernel launches (the plain version is not counted)
ctpf_estep.launches_double = 0   # of them, launches of the float64 mode


def ctpf_estep_pass_ref(ealefT, eheT, terms, counts, readers, ratings, doc_mask,
                        inv_db, inv_dv, inv_hv, gimel, zayin):
    """Plain PyTorch version of the pass mode: ``gsum = phi@counts +
    xi_top@ratings`` and ``zsum = xi_bot@ratings`` [B, K] over the token
    and reader slots given, phi and xi from (gimel, zayin) (CTPF.jl:309-323,
    the JAX package's models/ctpf.py:127-140); both 0 for a document with
    ``doc_mask`` 0."""
    gsum, zsum = _pass(ealefT[terms], eheT[readers], counts, ratings, gimel, zayin, inv_db,
                       inv_dv, inv_hv)
    act = (doc_mask > 0)[:, None]
    zero = torch.zeros_like(gsum)
    return torch.where(act, gsum, zero), torch.where(act, zsum, zero)


_PASS_ARGTYPES = [ctypes.c_void_p] * 15 + [ctypes.c_int64] * 4 + [ctypes.c_void_p]


def ctpf_estep_pass(ealefT, eheT, terms, counts, readers, ratings, doc_mask,
                    inv_db, inv_dv, inv_hv, gimel, zayin):
    """One pass of the CTPF fixpoint without its update: this rank's
    partial statistics ``(gsum, zsum)``, each [B, K] (see
    :func:`ctpf_estep_pass_ref`).  CPU tensors take
    :func:`ctpf_estep_pass_ref`; CUDA tensors launch the kernel, in the
    tables' dtype as :func:`ctpf_estep`, or raise."""
    args = (ealefT, eheT, terms, counts, readers, ratings, doc_mask, inv_db, inv_dv, inv_hv,
            gimel, zayin)
    if ealefT.device.type == "cpu":
        return ctpf_estep_pass_ref(*args)
    if ealefT.device.type != "cuda":
        raise ValueError(f"ctpf_estep_pass: no kernel for device {ealefT.device}")
    dt = ealefT.dtype
    _, suffix = _mode_of("ctpf_estep_pass", dt)
    (B, L, R, K), specs = _chunk_specs("ctpf_estep_pass", ealefT, eheT, terms, readers, dt,
                                       gimel=gimel, zayin=zayin)
    require("ctpf_estep_pass", ealefT.device, {
        **specs, "counts": (counts, (B, L), dt), "ratings": (ratings, (B, R), dt),
        "doc_mask": (doc_mask, (B,), dt), "inv_db": (inv_db, (K,), dt),
        "inv_dv": (inv_dv, (K,), dt), "inv_hv": (inv_hv, (K,), dt)})
    gsum = torch.empty((B, K), dtype=dt, device=ealefT.device)
    zsum = torch.empty((B, K), dtype=dt, device=ealefT.device)
    if B == 0:
        return gsum, zsum
    n_scratch = _scratch_elems(L, R, K, suffix)
    scratch = (torch.empty((B, n_scratch), dtype=dt, device=ealefT.device)
               if n_scratch else None)
    err = _build.launch(
        _build.function(f"tmvb_ctpf_estep_pass{suffix}", _PASS_ARGTYPES), ealefT.device,
        *(t.data_ptr() for t in (*args, gsum, zsum)),
        None if scratch is None else scratch.data_ptr(), B, L, R, K)
    check(err, "ctpf_estep_pass")
    ctpf_estep_pass.launches += 1
    ctpf_estep_pass.launches_double += dt == torch.float64
    return gsum, zsum


ctpf_estep_pass.launches = 0   # kernel launches (the plain version is not counted)
ctpf_estep_pass.launches_double = 0   # of them, launches of the float64 mode


def ctpf_split_fixpoint(ealefT, eheT, terms, counts, readers, ratings, doc_mask,
                        inv_db, inv_dv, inv_hv, gimel, gimel_old, zayin, zayin_old,
                        *, viter: int, vtol: float, c_hyper: float, g_hyper: float,
                        reduce=None):
    """The CTPF E-step over a chunk whose token and reader slots are split
    over ranks (the sequence axis): :func:`ctpf_estep`'s fixpoint with
    each pass's statistics from :func:`ctpf_estep_pass`, the pair summed
    by ``reduce`` in one call on their stack [2, B, K] (the psum over the
    ranks that hold the documents' other slots; None on one rank), and
    gimel, zayin, the masks and the per-document stop test on gimel on the
    tiles, as the JAX package computes them on this path (models/ctpf.py
    ``_estep_chunk``).  Returns ``(gimel, gimel_old, zayin, zayin_old, wa,
    wh)``, ``wa``/``wh`` over this rank's slots from the kernel at ``viter
    = 0`` (phi and xi from the final ``*_old``).  Every rank of a
    ``reduce`` group holds the same documents, so they test the same mask
    and stop together."""
    vtol2 = vtol * vtol

    def body(_, carry):
        gsum, zsum = ctpf_estep_pass(ealefT, eheT, terms, counts, readers, ratings,
                                     carry[4].to(counts.dtype), inv_db, inv_dv, inv_hv,
                                     carry[0], carry[2])
        if reduce is not None:
            gsum, zsum = reduce(torch.stack((gsum, zsum))).unbind(0)
        return _update(carry, gsum, zsum, c_hyper, g_hyper, vtol2)

    gimel, gimel_old, zayin, zayin_old, _ = masked_fixpoint(
        body, (gimel, gimel_old, zayin, zayin_old, doc_mask > 0), viter)
    return ctpf_estep(ealefT, eheT, terms, counts, readers, ratings, doc_mask, inv_db, inv_dv,
                      inv_hv, gimel, gimel_old, zayin, zayin_old, viter=0, vtol=vtol,
                      c_hyper=c_hyper, g_hyper=g_hyper)
