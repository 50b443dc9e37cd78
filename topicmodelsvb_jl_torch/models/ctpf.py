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
* On the sequence axis both ragged axes of a document, its token slots
  and its reader slots, are split over ranks: the fixpoint runs pass by
  pass (``ctpf_split_fixpoint``), each pass's gimel and zayin statistics
  summed over the axis in one collective, as the JAX package's XLA body
  does.
"""

from __future__ import annotations

import dataclasses

import torch

from ..kernels._build import check_dtype
from ..kernels.ctpf_estep import ctpf_estep, ctpf_split_fixpoint
from ..kernels.scatter_rows import build_plan
from ..ops.segment import count_scatter_into
from ..parallel.mesh import axis_tuple
from ..parallel.shard import all_gather, psum, tp_normalize_rows
from ..utils.numerics import (
    digamma, dirichlet_ones, gamma_entropy, kbn_add, kbn_merge, kbn_pack, kbn_psum, kbn_zero,
    lgamma, xlogx,
)
from .lda import _chunks, as_segments, check_modes, token_axes, token_plans, token_reduce

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


def estep_tables(g) -> tuple:
    """The E-step's tables from the globals ``g`` (any object with the
    CTPFState global fields): exp(ψ(alef))ᵀ [V, K], exp(ψ(he))ᵀ [U_seg, K]
    and the [K] vectors 1/(dalet·bet), 1/(dalet·vav), 1/(het·vav)."""
    ealefT = torch.exp(digamma(g.alef)).T.contiguous()          # [V, K]
    eheT = torch.exp(digamma(g.he)).T.contiguous()              # [U_seg, K]
    return (ealefT, eheT, 1.0 / (g.dalet * g.bet), 1.0 / (g.dalet * g.vav),
            1.0 / (g.het * g.vav))


def sweep_chunk(tables, t, cnt, rd, rt, dm, gimel, gimel_old, zayin, zayin_old, tplan, rplan,
                alef_temp, he_temp, viter: int, vtol: float, tok_reduce=None) -> tuple:
    """One chunk of the E-step sweep, on any chunk of [B, L] tokens and
    [B, R] readers: the fixpoint through ``ctpf_estep``, its term rows
    added into ``alef_temp`` [V, K] along ``tplan`` and its reader rows
    into ``he_temp`` [U_seg, K] along ``rplan``, in place.  Returns the
    chunk's new (gimel, gimel_old, zayin, zayin_old) and its gimel and
    zayin sums [K] over real documents.  ``tok_reduce`` (the sequence
    axis) runs the fixpoint pass by pass (``ctpf_split_fixpoint``), each
    pass's statistics summed by it."""
    ealefT, eheT, inv_db, inv_dv, inv_hv = tables
    args = (ealefT, eheT, t, cnt, rd, rt, dm, inv_db, inv_dv, inv_hv, gimel, gimel_old, zayin,
            zayin_old)
    kw = dict(viter=viter, vtol=vtol, c_hyper=HYPER["c"], g_hyper=HYPER["g"])
    if tok_reduce is None:
        gi2, gio2, za2, zao2, wa, wh = ctpf_estep(*args, **kw)
    else:
        gi2, gio2, za2, zao2, wa, wh = ctpf_split_fixpoint(*args, **kw, reduce=tok_reduce)
    K = wa.shape[-1]
    count_scatter_into(alef_temp, wa.reshape(-1, K), tplan)
    count_scatter_into(he_temp, wh.reshape(-1, K), rplan)
    return (gi2, gio2, za2, zao2, torch.sum(gi2 * dm[:, None], dim=0),
            torch.sum(za2 * dm[:, None], dim=0))


def global_update(alef_temp, he_temp, gimel_sum, zayin_sum, bet, vav, U: int,
                  row_sums=None) -> tuple:
    """(alef, bet, dalet, he, vav, het) from a sweep's statistics, in the
    reference's order (CTPF.jl:366-371).  ``row_sums(alef_sum, he_sum)``,
    when given, completes the [K] row sums of sharded alef/he blocks over
    their axes (the sums run over the whole V and U)."""
    a, b, c, d, e, f, g, h = (HYPER[k] for k in "abcdefgh")
    # he (CTPF.jl:266-270), alef (CTPF.jl:251-255)
    he_new = (e + he_temp.T).contiguous()
    alef_new = (a + alef_temp.T).contiguous()
    # dalet (CTPF.jl:295-298): new alef/he, OLD bet/vav
    he_sum = (torch.sum(he_new, dim=1) if U > 0
              else torch.zeros(gimel_sum.shape, dtype=gimel_sum.dtype, device=gimel_sum.device))
    alef_sum = torch.sum(alef_new, dim=1)
    if row_sums is not None:
        alef_sum, he_sum = row_sums(alef_sum, he_sum)
    dalet_new = d + alef_sum / bet + he_sum / vav
    # het (CTPF.jl:302-305): old vav
    het_new = h + he_sum / vav
    # bet (CTPF.jl:281-284): NEW dalet
    bet_new = b + gimel_sum / dalet_new
    # vav (CTPF.jl:288-291): NEW dalet and het
    vav_new = f + gimel_sum / dalet_new + zayin_sum / het_new
    return alef_new, bet_new, dalet_new, he_new, vav_new, het_new


def gathered(state: CTPFState, mesh, vocab_axis=None, user_axis=None,
             fields=("alef", "he")) -> CTPFState:
    """``state`` with the named alef/he fields whole: their ``[K, V/n]``
    blocks gathered over ``vocab_axis``, the ``[K, U/n]`` ones over
    ``user_axis``."""
    rep = {}
    for f in fields:
        axis = vocab_axis if f.startswith("alef") else user_axis
        if axis is not None:
            rep[f] = all_gather(getattr(state, f), mesh, axis, dim=1)
    return dataclasses.replace(state, **rep) if rep else state


def make_step(packed, K: int, viter: int, vtol: float, chunk_docs: int, device,
              mesh=None, axis_name=None, vocab_axis=None, user_axis=None, seq_axis=None):
    """Build the outer-iteration step (one full CAVI sweep).

    ``step(state, terms, counts, readers, ratings, doc_mask)`` takes the
    per-segment tuples of terms/counts/doc_mask (one tensor each for a
    dense corpus) and the dense reader arrays on ``device``, and returns
    the next state; the chunks' two scatter plans (``lda.token_plans``,
    :func:`reader_plans`) are built here and put on ``device``.  With a
    ``mesh`` (``packed`` this process's slab), gimel_sum, zayin_sum,
    alef_temp and he_temp are summed over ``axis_name`` before the global
    update.  ``vocab_axis`` shards alef's storage (``[K, V/n]`` blocks)
    and ``user_axis`` he's (``[K, U/n]``): both are gathered whole for the
    E-step's tables, each statistic keeps its block through
    ``tp_normalize_rows``, and the [K] row sums are completed over the
    axis.  ``seq_axis`` splits every document's token and reader slots
    (``packed`` the slab of this process's rows, token columns and reader
    columns, dense, ``multihost.local_slab``): each pass's statistics are
    summed over it, and so are alef's and he's statistics, while the gimel
    and zayin sums run over ``axis_name`` alone (the JAX package's
    models/ctpf.py:300-318).
    """
    check_modes(vocab_axis, seq_axis, False, packed)
    V, U = packed.V, packed.U
    U_seg = max(U, 1)
    axes = axis_tuple(axis_name)
    tok_axes = token_axes(axis_name, seq_axis)
    tok_reduce = token_reduce(mesh, seq_axis)
    chunks = _chunks(packed, chunk_docs)
    tplans = token_plans(packed, chunk_docs, device)
    rplans = reader_plans(packed, chunk_docs, device)

    def reduce_stat(temp, shard_axis):
        if shard_axis is None:
            return psum(temp, mesh, tok_axes)
        return tp_normalize_rows(temp, mesh, shard_axis, tok_axes)[0]

    def row_sums(alef_sum, he_sum):
        if vocab_axis is not None:
            alef_sum = psum(alef_sum, mesh, vocab_axis)
        if user_axis is not None and U > 0:
            he_sum = psum(he_sum, mesh, user_axis)
        return alef_sum, he_sum

    def step(state: CTPFState, terms, counts, readers, ratings, doc_mask) -> CTPFState:
        terms, counts, doc_mask = (as_segments(x) for x in (terms, counts, doc_mask))
        dt, dev = state.alef.dtype, state.alef.device
        check_dtype("CTPF", dt, dev, ("seq",) * (seq_axis is not None))
        tables = estep_tables(gathered(state, mesh, vocab_axis, user_axis))
        alef_temp = torch.zeros((V, K), dtype=dt, device=dev)
        he_temp = torch.zeros((U_seg, K), dtype=dt, device=dev)
        gimel_sum = torch.zeros((K,), dtype=dt, device=dev)
        zayin_sum = torch.zeros((K,), dtype=dt, device=dev)
        new = {f_: torch.empty_like(getattr(state, f_))
               for f_ in ("gimel", "gimel_old", "zayin", "zayin_old")}
        for (rows, j, sl), tplan, rplan in zip(chunks, tplans, rplans):
            *out, gs, zs = sweep_chunk(
                tables, terms[j][sl], counts[j][sl], readers[rows], ratings[rows],
                doc_mask[j][sl], state.gimel[rows], state.gimel_old[rows],
                state.zayin[rows], state.zayin_old[rows], tplan, rplan, alef_temp, he_temp,
                viter, vtol, tok_reduce)
            gimel_sum = gimel_sum + gs
            zayin_sum = zayin_sum + zs
            for f_, v in zip(new, out):
                new[f_][rows] = v

        gimel_sum, zayin_sum = (psum(x, mesh, axes) for x in (gimel_sum, zayin_sum))
        alef_new, bet_new, dalet_new, he_new, vav_new, het_new = global_update(
            reduce_stat(alef_temp, vocab_axis), reduce_stat(he_temp, user_axis), gimel_sum,
            zayin_sum, state.bet, state.vav, U, row_sums)
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


def _prior(n, shape, rate, dt, dev):
    """Gamma prior normaliser n·(shape·log rate − lnΓ(shape))."""
    const = lambda x: torch.tensor(x, dtype=dt, device=dev)
    return n * (shape * torch.log(const(rate)) - lgamma(const(shape)))


def elbo_tables(g, U: int) -> dict:
    """What every chunk of the bound shares, from the globals ``g`` (any
    object with the CTPFState global fields): phi/xi come from the *_old
    parameter set (CTPF.jl:240-241), the terms from the current one."""
    K = g.alef.shape[0]
    dt, dev = g.alef.dtype, g.alef.device
    dg_alef, dg_he = digamma(g.alef), digamma(g.he)
    return dict(
        K=K, U=U, alef=g.alef, he=g.he, bet=g.bet, vav=g.vav, dalet=g.dalet, het=g.het,
        dg_alef=dg_alef, dg_he=dg_he,
        log_bet_o=torch.log(g.bet_old), log_vav_o=torch.log(g.vav_old),
        log_dalet_o=torch.log(g.dalet_old), log_het_o=torch.log(g.het_old),
        log_bet=torch.log(g.bet), log_vav=torch.log(g.vav),
        log_dalet=torch.log(g.dalet), log_het=torch.log(g.het),
        alef_sum=torch.sum(g.alef, dim=1),                               # Σ_j alef [K]
        he_sum=(torch.sum(g.he, dim=1) if U > 0
                else torch.zeros((K,), dtype=dt, device=dev)),
        # [V, 2K] / [U, 2K] tables: old- and current-param rows side by side
        vtab=torch.cat([digamma(g.alef_old).T, dg_alef.T], dim=1),
        utab=torch.cat([digamma(g.he_old).T, dg_he.T], dim=1))


def global_terms(tb: dict) -> torch.Tensor:
    """The data-independent bound terms: Elogpbeta − Elogqbeta
    (CTPF.jl:144-150, 198-204) and Elogpeta − Elogqeta (CTPF.jl:162-168,
    216-222)."""
    a, b, e, f = (HYPER[k] for k in "abef")
    K, U, alef, he, bet, vav = tb["K"], tb["U"], tb["alef"], tb["he"], tb["bet"], tb["vav"]
    dt, dev = alef.dtype, alef.device
    V = alef.shape[1]
    e_pbeta = _prior(V * K, a, b, dt, dev) + torch.sum(
        (a - 1.0) * (tb["dg_alef"] - tb["log_bet"][:, None]) - b * alef / bet[:, None])
    e_qbeta_ent = torch.sum(gamma_entropy(alef, bet[:, None]))
    if U > 0:
        e_peta = _prior(U * K, e, f, dt, dev) + torch.sum(
            (e - 1.0) * (tb["dg_he"] - tb["log_vav"][:, None]) - f * he / vav[:, None])
        e_qeta_ent = torch.sum(gamma_entropy(he, vav[:, None]))
    else:
        e_peta = e_qeta_ent = torch.zeros((), dtype=dt, device=dev)
    return e_pbeta + e_qbeta_ent + e_peta + e_qeta_ent


def elbo_chunk(tb: dict, t, cnt, rd, rt, dm, gi, gio, za, zao) -> tuple:
    """One chunk's bound, on any chunk of [B, L] tokens and [B, R]
    readers: (doc terms, token terms), each summed over its real
    documents (CTPF.jl:110-247 with the E[lnΓ(y+1)] cancellation)."""
    c, d, g, h = (HYPER[k] for k in "cdgh")
    K = tb["K"]
    dalet, het, vav, bet = tb["dalet"], tb["het"], tb["vav"], tb["bet"]
    log_dalet, log_het, log_vav, log_bet = (tb["log_dalet"], tb["log_het"], tb["log_vav"],
                                            tb["log_bet"])
    dt, dev = gi.dtype, gi.device
    vt, ut = tb["vtab"][t], tb["utab"][rd]                   # [B, L, 2K], [B, R, 2K]
    dg_gi_o, dg_za_o = digamma(gio), digamma(zao)
    p = torch.softmax(vt[..., :K] + (dg_gi_o - tb["log_dalet_o"] - tb["log_bet_o"])[:, None, :],
                      dim=-1)
    xi_top, xi_bot = _xi(ut[..., :K], dg_gi_o, dg_za_o,
                         tb["log_dalet_o"], tb["log_het_o"], tb["log_vav_o"])
    dg_gi, dg_za = digamma(gi), digamma(za)

    # Elogpya + Elogpyb − Elogqy, E[lnΓ] cancelled (CTPF.jl:111-130, 180-186)
    lin_top = (dg_gi - log_dalet)[:, None, :] + ut[..., K:] - log_vav
    lin_bot = (dg_za - log_het)[:, None, :] + ut[..., K:] - log_vav
    rate_lin = torch.sum(rt[..., None] * (xi_top * lin_top + xi_bot * lin_bot), dim=(1, 2))
    xi_ent = torch.sum(xlogx(xi_top) + xlogx(xi_bot), dim=-1)   # Σ xi ln xi
    rate_q = torch.sum(lgamma(rt + 1.0) + rt * xi_ent, dim=1)
    dot_ya = torch.sum((gi / (dalet * vav)) * tb["he_sum"], -1)
    dot_yb = torch.sum((za / (het * vav)) * tb["he_sum"], -1)

    # Elogpz − Elogqz, E[lnΓ] cancelled (CTPF.jl:133-141, 189-195)
    lin_z = (dg_gi - log_dalet)[:, None, :] + vt[..., K:] - log_bet
    tok_lin = torch.sum(cnt[..., None] * p * lin_z, dim=(1, 2))
    p_ent = torch.sum(xlogx(p), dim=-1)
    tok_q = torch.sum(lgamma(cnt + 1.0) + cnt * p_ent, dim=1)
    dot_z = torch.sum((gi / (dalet * bet)) * tb["alef_sum"], -1)

    # Elogptheta (CTPF.jl:153-159) − Elogqtheta (CTPF.jl:207-213)
    e_pth = _prior(K, c, d, dt, dev) + torch.sum(
        (c - 1.0) * (dg_gi - log_dalet) - d * gi / dalet, -1)
    e_qth = torch.sum(gamma_entropy(gi, dalet[None, :]), -1)
    # Elogpepsilon (CTPF.jl:171-177) − Elogqepsilon (CTPF.jl:225-231)
    e_pep = _prior(K, g, h, dt, dev) + torch.sum(
        (g - 1.0) * (dg_za - log_het) - h * za / het, -1)
    e_qep = torch.sum(gamma_entropy(za, het[None, :]), -1)
    return (torch.sum(dm * (-dot_ya - dot_yb - dot_z + e_pth + e_qth + e_pep + e_qep)),
            torch.sum(dm * (rate_lin - rate_q + tok_lin - tok_q)))


def make_elbo(packed, K: int, chunk_docs: int, mesh=None, axis_name=None, vocab_axis=None,
              user_axis=None, seq_axis=None):
    """Closed-form ELBO (CTPF.jl:110-247 with the E[lnΓ(y+1)] cancellation).

    phi/xi are recomputed from the *_old parameter set (CTPF.jl:240-241);
    all bound terms use the current parameters.  With a ``mesh``, the
    document and token sums are reduced over ``axis_name`` before the
    global terms are added; ``vocab_axis``/``user_axis`` gather alef and
    alef_old, he and he_old whole first.  With ``seq_axis`` the token and
    reader terms, linear in each slot, sum over it too, and the document
    terms, which use no token sum, do not (the JAX package's
    models/ctpf.py:510-521).
    """
    check_modes(vocab_axis, seq_axis, False, packed)
    U = packed.U
    chunks = _chunks(packed, chunk_docs)
    tok_axes = token_axes(axis_name, seq_axis)

    def elbo(state: CTPFState, terms, counts, readers, ratings, doc_mask) -> torch.Tensor:
        terms, counts, doc_mask = (as_segments(x) for x in (terms, counts, doc_mask))
        dt, dev = state.alef.dtype, state.alef.device
        tb = elbo_tables(gathered(state, mesh, vocab_axis, user_axis,
                                  ("alef", "alef_old", "he", "he_old")), U)
        acc_doc, acc_tok = kbn_zero(dt, dev), kbn_zero(dt, dev)
        for rows, j, sl in chunks:
            doc, tok = elbo_chunk(tb, terms[j][sl], counts[j][sl], readers[rows],
                                  ratings[rows], doc_mask[j][sl], state.gimel[rows],
                                  state.gimel_old[rows], state.zayin[rows],
                                  state.zayin_old[rows])
            acc_doc = kbn_add(acc_doc, doc)
            acc_tok = kbn_add(acc_tok, tok)
        acc_doc = kbn_psum(acc_doc, mesh, axis_name)
        acc_tok = kbn_psum(acc_tok, mesh, tok_axes)
        return kbn_pack(kbn_add(kbn_merge(acc_doc, acc_tok), global_terms(tb)))

    return elbo


def scores(state: CTPFState) -> torch.Tensor:
    """Dense recommendation scores Eeta'·(Etheta+Eepsilon) (CTPF.jl:381-386),
    [M_pad, U_seg], one matrix product on the state's device."""
    Eeta = state.he / state.vav[:, None]                 # [K, U]
    Etheta = state.gimel / state.dalet[None, :]          # [M, K]
    Eeps = state.zayin / state.het[None, :]
    return (Etheta + Eeps) @ Eeta
