"""Collaborative topic Poisson factorization — batch-synchronous CAVI on one device.

PyTorch port of the JAX package's ``models/ctpf.py`` on its bucketed
single-device path (reference ``src/CTPF.jl``, Gopalan/Charlin/Blei, and
its OpenCL twin ``src/gpuCTPF.jl``).  Document content (terms) and user
behaviour (readers/ratings) share the Gamma posteriors alef/bet
(topic-word), gimel/dalet (doc-topic), he/vav (user preference) and
zayin/het (doc offset).

* The per-document E-step fixpoint (CTPF.jl:352-360) runs chunk by chunk
  through ``kernels/ctpf_estep``.  The tables exp(ψ(alef))ᵀ [V, K] and
  exp(ψ(he))ᵀ [U, K] and the [K] vectors 1/(dalet·bet), 1/(dalet·vav),
  1/(het·vav) are computed once per step on the device.
* Only the token axis is bucketed: the reader arrays stay dense
  ``[M_pad, Rmax]`` and are row-sliced per chunk.
* Two deterministic scatters: the alef statistic over term ids, the he
  statistic over reader ids, each along the chunk's plan
  (``lda.token_plans``, :func:`reader_plans`).  A corpus without users
  runs with one placeholder user and all ratings 0, as in the JAX package.
* The ELBO is the closed form with the E[lnΓ(y+1)] cancellation
  (see the JAX module's docstring), in plain PyTorch.
"""

from __future__ import annotations

import dataclasses

import torch

from ..kernels.ctpf_estep import ctpf_estep
from ..kernels.scatter_rows import build_plan
from ..ops.segment import count_scatter_into
from ..utils.numerics import (
    digamma, dirichlet_ones, gamma_entropy, kbn_add, kbn_merge, kbn_pack, kbn_zero,
    lgamma, xlogx,
)
from .lda import _chunks, token_plans

# Gamma hyperpriors a..h = 0.1 (CTPF.jl:81)
HYPER = dict(a=0.1, b=0.1, c=0.1, d=0.1, e=0.1, f=0.1, g=0.1, h=0.1)


@dataclasses.dataclass
class CTPFState:
    alef: torch.Tensor       # [K, V]
    alef_old: torch.Tensor
    bet: torch.Tensor        # [K]
    bet_old: torch.Tensor
    gimel: torch.Tensor      # [M_pad, K]
    gimel_old: torch.Tensor
    dalet: torch.Tensor      # [K]
    dalet_old: torch.Tensor
    he: torch.Tensor         # [K, U_seg]
    he_old: torch.Tensor
    vav: torch.Tensor        # [K]
    vav_old: torch.Tensor
    zayin: torch.Tensor      # [M_pad, K]
    zayin_old: torch.Tensor
    het: torch.Tensor        # [K]
    het_old: torch.Tensor
    elbo: torch.Tensor       # compensated (hi, lo) bound, shape (2,)


def init(generator: torch.Generator, packed, K: int, dtype=torch.float32,
         device="cpu") -> CTPFState:
    """Constructor state (reference CTPF.jl:81-103).  alef is drawn on
    ``generator``'s device and then moved to ``device``."""
    M_pad, V = packed.M_pad, packed.V
    U_seg = max(packed.U, 1)
    alef = torch.exp(dirichlet_ones(generator, V, (K,), dtype) - 0.5).to(device)
    ones = lambda *shape: torch.ones(shape, dtype=dtype, device=device)
    return CTPFState(
        alef=alef, alef_old=alef, bet=ones(K), bet_old=ones(K),
        gimel=ones(M_pad, K), gimel_old=ones(M_pad, K), dalet=ones(K), dalet_old=ones(K),
        he=ones(K, U_seg), he_old=ones(K, U_seg), vav=ones(K), vav_old=ones(K),
        zayin=ones(M_pad, K), zayin_old=ones(M_pad, K), het=ones(K), het_old=ones(K),
        elbo=torch.zeros((2,), dtype=dtype, device=device),
    )


def reader_plans(packed, chunk_docs: int, device) -> list:
    """One scatter plan per chunk, in sweep order, over its reader slots
    with ``ratings > 0``: built from the host arrays, put on ``device``."""
    return [build_plan(packed.readers[rows], packed.ratings[rows] > 0).to(device)
            for rows, _, _ in _chunks(packed, chunk_docs)]


def make_step(packed, K: int, viter: int, vtol: float, chunk_docs: int, device):
    """Build the outer-iteration step (one full CAVI sweep).

    ``step(state, terms, counts, readers, ratings, doc_mask)`` takes the
    per-segment tuples of terms/counts/doc_mask and the dense reader
    arrays on ``device``, and returns the next state; the chunks' two
    scatter plans (``lda.token_plans``, :func:`reader_plans`) are built
    here and put on ``device``.
    """
    V, U = packed.V, packed.U
    U_seg = max(U, 1)
    a, b, c, d, e, f, g, h = (HYPER[k] for k in "abcdefgh")
    chunks = _chunks(packed, chunk_docs)
    tplans = token_plans(packed, chunk_docs, device)
    rplans = reader_plans(packed, chunk_docs, device)

    def step(state: CTPFState, terms, counts, readers, ratings, doc_mask) -> CTPFState:
        dt, dev = state.alef.dtype, state.alef.device
        ealefT = torch.exp(digamma(state.alef)).T.contiguous()      # [V, K]
        eheT = torch.exp(digamma(state.he)).T.contiguous()          # [U_seg, K]
        inv_db = 1.0 / (state.dalet * state.bet)
        inv_dv = 1.0 / (state.dalet * state.vav)
        inv_hv = 1.0 / (state.het * state.vav)
        alef_temp = torch.zeros((V, K), dtype=dt, device=dev)
        he_temp = torch.zeros((U_seg, K), dtype=dt, device=dev)
        gimel_sum = torch.zeros((K,), dtype=dt, device=dev)
        zayin_sum = torch.zeros((K,), dtype=dt, device=dev)
        new = {f_: torch.empty_like(getattr(state, f_))
               for f_ in ("gimel", "gimel_old", "zayin", "zayin_old")}
        for (rows, j, sl), tplan, rplan in zip(chunks, tplans, rplans):
            t, cnt, dm = terms[j][sl], counts[j][sl], doc_mask[j][sl]
            rd, rt = readers[rows], ratings[rows]
            gi2, gio2, za2, zao2, wa, wh = ctpf_estep(
                ealefT, eheT, t, cnt, rd, rt, dm, inv_db, inv_dv, inv_hv,
                state.gimel[rows], state.gimel_old[rows],
                state.zayin[rows], state.zayin_old[rows],
                viter=viter, vtol=vtol, c_hyper=c, g_hyper=g)
            count_scatter_into(alef_temp, wa.reshape(-1, K), tplan)
            count_scatter_into(he_temp, wh.reshape(-1, K), rplan)
            gimel_sum = gimel_sum + torch.sum(gi2 * dm[:, None], dim=0)
            zayin_sum = zayin_sum + torch.sum(za2 * dm[:, None], dim=0)
            for f_, v in zip(new, (gi2, gio2, za2, zao2)):
                new[f_][rows] = v

        # global updates, reference order (CTPF.jl:366-371):
        # he (CTPF.jl:266-270), alef (CTPF.jl:251-255)
        he_new = (e + he_temp.T).contiguous()
        alef_new = (a + alef_temp.T).contiguous()
        # dalet (CTPF.jl:295-298): new alef/he, OLD bet/vav
        he_sum = (torch.sum(he_new, dim=1) if U > 0
                  else torch.zeros((K,), dtype=dt, device=dev))
        alef_sum = torch.sum(alef_new, dim=1)
        dalet_new = d + alef_sum / state.bet + he_sum / state.vav
        # het (CTPF.jl:302-305): old vav
        het_new = h + he_sum / state.vav
        # bet (CTPF.jl:281-284): NEW dalet
        bet_new = b + gimel_sum / dalet_new
        # vav (CTPF.jl:288-291): NEW dalet and het
        vav_new = f + gimel_sum / dalet_new + zayin_sum / het_new
        return CTPFState(
            alef=alef_new, alef_old=state.alef, bet=bet_new, bet_old=state.bet,
            dalet=dalet_new, dalet_old=state.dalet, he=he_new, he_old=state.he,
            vav=vav_new, vav_old=state.vav, het=het_new, het_old=state.het,
            elbo=state.elbo, **new,
        )

    return step


def _xi(dg_he_d, dg_gimel, dg_zayin, log_dalet, log_het, log_vav):
    """xi ∝ softmax over 2K of stacked content/offset halves (CTPF.jl:334-337).

    Returns ([B,R,K] top, [B,R,K] bottom)."""
    top = dg_he_d + (dg_gimel - log_dalet - log_vav)[:, None, :]
    bot = dg_he_d + (dg_zayin - log_het - log_vav)[:, None, :]
    m = torch.maximum(torch.amax(top, -1, keepdim=True), torch.amax(bot, -1, keepdim=True))
    et, eb = torch.exp(top - m), torch.exp(bot - m)
    z = torch.sum(et, -1, keepdim=True) + torch.sum(eb, -1, keepdim=True)
    return et / z, eb / z


def make_elbo(packed, K: int, chunk_docs: int):
    """Closed-form ELBO (CTPF.jl:110-247 with the E[lnΓ(y+1)] cancellation).

    phi/xi are recomputed from the *_old parameter set (CTPF.jl:240-241);
    all bound terms use the current parameters.
    """
    V, U = packed.V, packed.U
    a, b, c, d, e, f, g, h = (HYPER[k] for k in "abcdefgh")
    chunks = _chunks(packed, chunk_docs)

    def elbo(state: CTPFState, terms, counts, readers, ratings, doc_mask) -> torch.Tensor:
        dt, dev = state.alef.dtype, state.alef.device
        const = lambda x: torch.tensor(x, dtype=dt, device=dev)
        # Gamma prior normaliser n·(shape·log rate − lnΓ(shape))
        prior = lambda n, shape, rate: n * (shape * torch.log(const(rate))
                                            - lgamma(const(shape)))
        alef, he, het = state.alef, state.he, state.het
        # old-param responsibilities (CTPF.jl:240-241)
        log_bet_o, log_vav_o = torch.log(state.bet_old), torch.log(state.vav_old)
        log_dalet_o, log_het_o = torch.log(state.dalet_old), torch.log(state.het_old)
        # current params for the bound
        dg_alef, dg_he = digamma(alef), digamma(he)
        log_bet, log_vav = torch.log(state.bet), torch.log(state.vav)
        log_dalet, log_het = torch.log(state.dalet), torch.log(het)
        alef_sum = torch.sum(alef, dim=1)                              # Σ_j alef [K]
        he_sum = torch.sum(he, dim=1) if U > 0 else torch.zeros((K,), dtype=dt, device=dev)

        # Elogpbeta (CTPF.jl:144-150) − Elogqbeta (CTPF.jl:198-204)
        e_pbeta = prior(V * K, a, b) + torch.sum(
            (a - 1.0) * (dg_alef - log_bet[:, None]) - b * alef / state.bet[:, None])
        e_qbeta_ent = torch.sum(gamma_entropy(alef, state.bet[:, None]))
        # Elogpeta (CTPF.jl:162-168) − Elogqeta (CTPF.jl:216-222)
        if U > 0:
            e_peta = prior(U * K, e, f) + torch.sum(
                (e - 1.0) * (dg_he - log_vav[:, None]) - f * he / state.vav[:, None])
            e_qeta_ent = torch.sum(gamma_entropy(he, state.vav[:, None]))
        else:
            e_peta = e_qeta_ent = torch.zeros((), dtype=dt, device=dev)

        # [V, 2K] / [U, 2K] tables: old- and current-param rows side by side
        vtab = torch.cat([digamma(state.alef_old).T, dg_alef.T], dim=1)
        utab = torch.cat([digamma(state.he_old).T, dg_he.T], dim=1)
        acc_doc, acc_tok = kbn_zero(dt, dev), kbn_zero(dt, dev)
        for rows, j, sl in chunks:
            t, cnt, dm = terms[j][sl], counts[j][sl], doc_mask[j][sl]
            rd, rt = readers[rows], ratings[rows]
            gi, gio = state.gimel[rows], state.gimel_old[rows]
            za, zao = state.zayin[rows], state.zayin_old[rows]
            vt, ut = vtab[t], utab[rd]                      # [B, L, 2K], [B, R, 2K]
            dg_gi_o, dg_za_o = digamma(gio), digamma(zao)
            p = torch.softmax(vt[..., :K] + (dg_gi_o - log_dalet_o - log_bet_o)[:, None, :],
                              dim=-1)
            xi_top, xi_bot = _xi(ut[..., :K], dg_gi_o, dg_za_o,
                                 log_dalet_o, log_het_o, log_vav_o)
            dg_gi, dg_za = digamma(gi), digamma(za)

            # Elogpya + Elogpyb − Elogqy, E[lnΓ] cancelled (CTPF.jl:111-130, 180-186)
            lin_top = (dg_gi - log_dalet)[:, None, :] + ut[..., K:] - log_vav
            lin_bot = (dg_za - log_het)[:, None, :] + ut[..., K:] - log_vav
            rate_lin = torch.sum(rt[..., None] * (xi_top * lin_top + xi_bot * lin_bot),
                                 dim=(1, 2))
            xi_ent = torch.sum(xlogx(xi_top) + xlogx(xi_bot), dim=-1)   # Σ xi ln xi
            rate_q = torch.sum(lgamma(rt + 1.0) + rt * xi_ent, dim=1)
            dot_ya = torch.sum((gi / (state.dalet * state.vav)) * he_sum, -1)
            dot_yb = torch.sum((za / (het * state.vav)) * he_sum, -1)

            # Elogpz − Elogqz, E[lnΓ] cancelled (CTPF.jl:133-141, 189-195)
            lin_z = (dg_gi - log_dalet)[:, None, :] + vt[..., K:] - log_bet
            tok_lin = torch.sum(cnt[..., None] * p * lin_z, dim=(1, 2))
            p_ent = torch.sum(xlogx(p), dim=-1)
            tok_q = torch.sum(lgamma(cnt + 1.0) + cnt * p_ent, dim=1)
            dot_z = torch.sum((gi / (state.dalet * state.bet)) * alef_sum, -1)

            # Elogptheta (CTPF.jl:153-159) − Elogqtheta (CTPF.jl:207-213)
            e_pth = prior(K, c, d) + torch.sum(
                (c - 1.0) * (dg_gi - log_dalet) - d * gi / state.dalet, -1)
            e_qth = torch.sum(gamma_entropy(gi, state.dalet[None, :]), -1)
            # Elogpepsilon (CTPF.jl:171-177) − Elogqepsilon (CTPF.jl:225-231)
            e_pep = prior(K, g, h) + torch.sum(
                (g - 1.0) * (dg_za - log_het) - h * za / het, -1)
            e_qep = torch.sum(gamma_entropy(za, het[None, :]), -1)

            acc_doc = kbn_add(acc_doc, torch.sum(dm * (
                -dot_ya - dot_yb - dot_z + e_pth + e_qth + e_pep + e_qep)))
            acc_tok = kbn_add(acc_tok, torch.sum(dm * (
                rate_lin - rate_q + tok_lin - tok_q)))
        total = kbn_merge(acc_doc, acc_tok)
        return kbn_pack(kbn_add(total, e_pbeta + e_qbeta_ent + e_peta + e_qeta_ent))

    return elbo


def scores(state: CTPFState) -> torch.Tensor:
    """Dense recommendation scores Eeta'·(Etheta+Eepsilon) (CTPF.jl:381-386),
    [M_pad, U_seg], one matrix product on the state's device."""
    Eeta = state.he / state.vav[:, None]                 # [K, U]
    Etheta = state.gimel / state.dalet[None, :]          # [M, K]
    Eeps = state.zayin / state.het[None, :]
    return (Etheta + Eeps) @ Eeta
