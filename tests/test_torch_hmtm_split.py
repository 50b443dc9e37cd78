"""The split form of HMTM's E-step and normaliser against the JAX package,
on CPU, in float64.

The kernels of ``kernels/csrc/hmtm_estep.cu`` run a pass, up to 32 topics,
as a forward and a backward normalised by its own sums that walk the
chain at once and combine where they meet; logZ meets the two halves at
mid = last // 2.  The functions below are those formulas as vectorised
torch (the formulas, not the kernel's schedule).  In exact arithmetic
they are JAX's posteriors and normaliser, EPSILON included; here they,
and the port's plain ``hmtm_estep_ref``/``hmtm_logz_ref`` (JAX's own
form, which the CPU runs and the card is checked against), are held to
JAX ``_estep_chunk``, ``_forward`` and ``_backward_stats`` at 1e-10 on the
shapes where the split has edges: documents of 1, 2, 3, 64 and 65 slots,
a midpoint on padding, a padded first slot, an empty document, a
doc_mask 0 row, and slots whose emission is EPSILON in every topic (a
term no topic holds, as ``predict`` meets on unseen terms), at viter 0, 1
and 10.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from topicmodelsvb_jl_tpu.models import hmtm as jax_hmtm
from topicmodelsvb_jl_torch.kernels.hmtm_estep import _tilde, hmtm_estep_ref, hmtm_logz_ref
from topicmodelsvb_jl_torch.utils.numerics import EPSILON, l2norm, masked_fixpoint

K, V = 5, 30


def split_forward(p0, A, Bv, tmask):
    """Scaled forward pass (JAX ``_forward``): messages a [B, L, K], the
    scaler of each slot's message C [B, L] (Σ f + EPSILON, carried over
    padding; slot 0's even when it is padding) and the effective scalers c
    [B, L] (C on real slots, 1 on padding)."""
    m0 = tmask[:, 0] > 0
    f0 = torch.where(m0[:, None], p0 * Bv[:, 0], p0)
    C_prev = torch.sum(f0, -1) + EPSILON
    a_prev = f0 / C_prev[:, None]
    a, C = [a_prev], [C_prev]
    for n in range(1, Bv.shape[1]):
        f = Bv[:, n] * torch.einsum("bil,bl->bi", A, a_prev)
        cn = torch.sum(f, -1) + EPSILON
        upd = tmask[:, n] > 0
        a_prev = torch.where(upd[:, None], f / cn[:, None], a_prev)
        C_prev = torch.where(upd, cn, C_prev)
        a.append(a_prev)
        C.append(C_prev)
    C = torch.stack(C, 1)
    return torch.stack(a, 1), C, torch.where(tmask > 0, C, torch.ones_like(C))


def split_backward(A, Bv, tmask, sink: float):
    """The backward pass normalised by its own sums, which needs nothing
    from the forward: bt [B, L, K], 1 from the last real slot on and, on a
    real slot n, v_n = B_n ⊙ bt_n, d_n = Σ v_n + EPSILON, bt_{n-1} = (Aᵀ
    v_n + EPSILON bs_n) / d_n, bs_{n-1} = EPSILON bs_n / d_n (a padding
    slot carries bt and bs and has d = 1); returns bt, bs [B, L] and d [B,
    L].  bs is the backward message of the forward's EPSILON, a sink state
    that every message leaks EPSILON / C into: ``sink`` = 0 gives JAX's
    backward (be_n = bt_n Σa_last / (a_n · bt_n)), ``sink`` = 1 the one
    whose product with the forward's message, sink included, is 1 at the
    last real slot.  d_n is the counterpart of the forward's c_n, the sum
    of the emission-weighted message; any positive normaliser cancels in
    r, S and logZ."""
    B, L, K = Bv.shape
    bt = torch.ones((B, K), dtype=Bv.dtype, device=Bv.device)
    bs = torch.full((B,), float(sink), dtype=Bv.dtype, device=Bv.device)
    out, outs = [bt] * L, [bs] * L
    d = [torch.ones((B,), dtype=Bv.dtype, device=Bv.device)] * L
    for n in range(L - 1, 0, -1):
        upd = tmask[:, n] > 0
        v = Bv[:, n] * bt
        dn = torch.sum(v, -1) + EPSILON
        u = torch.einsum("bil,bi->bl", A, v) + EPSILON * bs[:, None]
        bt = torch.where(upd[:, None], u / dn[:, None], bt)
        bs = torch.where(upd, EPSILON * bs / dn, bs)
        d[n] = torch.where(upd, dn, torch.ones_like(dn))
        out[n - 1], outs[n - 1] = bt, bs
    return torch.stack(out, 1), torch.stack(outs, 1), torch.stack(d, 1)


def _last(tmask):
    """Each document's last real slot, -1 when it has none."""
    pos = torch.arange(tmask.shape[1], device=tmask.device)
    return torch.where(tmask > 0, pos, -1).max(1).values


def split_combine(a, c, bt, A, Bv, tmask):
    """The forward and the normalised backward (``sink`` = 0) combined
    into JAX ``_backward_stats``'s outputs: r [B, L, K] = q(z_n) = s a_n ⊙
    bt_n / (a_n · bt_n) on real slots, 0 on padding, and xi_sum [B, K, K]
    = s A ⊙ S, S = Σ_{n≥1 real} (B_n ⊙ bt_n) a_{n-1}ᵀ / (c_n (a_n ·
    bt_n)), where s = Σ a_last (1 but for EPSILON / c_last)."""
    real = tmask > 0
    rows = torch.arange(a.shape[0], device=a.device)
    s = torch.sum(a[rows, torch.clamp(_last(tmask), min=0)], -1)
    z = torch.sum(a * bt, -1)                                   # [B, L]
    r = torch.where(real[..., None], a * bt * (s[:, None] / z)[..., None], torch.zeros_like(a))
    g = Bv[:, 1:] * bt[:, 1:] / (c[:, 1:] * z[:, 1:])[..., None]
    g = torch.where(real[:, 1:, None], g, torch.zeros_like(g))
    return r, s[:, None, None] * A * torch.einsum("bni,bnl->bil", g, a[:, :-1])


def split_logz(a, C, c, bt, bs, d, tmask):
    """logZ [B] from the two halves of the chain meeting at mid = last // 2
    (last: the document's last real slot) with the backward of ``sink`` =
    1: Σ_{n≤mid} log c_n + Σ_{n>mid} log d_n + log(a_mid · bt_mid +
    EPSILON bs_mid / C_mid), JAX's Σ_n log c_n in exact arithmetic; exactly
    0 for a document with no real slot."""
    B, L = tmask.shape
    last = _last(tmask)
    mid = torch.clamp(last, min=0) // 2
    rows = torch.arange(B, device=tmask.device)
    zm = torch.sum(a[rows, mid] * bt[rows, mid], -1) + EPSILON * bs[rows, mid] / C[rows, mid]
    head = torch.arange(L, device=tmask.device)[None, :] <= mid[:, None]
    lz = torch.sum(torch.where(head, torch.log(c), torch.log(d)), -1) + torch.log(zm)
    return torch.where(last >= 0, lz, torch.zeros_like(lz))


def split_estep(betaT_eps, terms, tmask, doc_mask, eta, alpha, tau, gamma,
                   *, viter: int, vtol: float):
    """JAX ``_estep_chunk`` less its scatter, a pass in the split form:
    the forward, the normalised backward and their combine, the split
    kernel's formulas; the chunk's documents run the fixpoint together,
    each frozen once it converges."""
    Bv = betaT_eps[terms]                                  # [B, L, K]

    def body(_, carry):
        tau, gamma, active = carry
        p0, A = _tilde(tau, gamma)
        a, _, c = split_forward(p0, A, Bv, tmask)
        r, xi_sum = split_combine(a, c, split_backward(A, Bv, tmask, 0.0)[0], A, Bv, tmask)
        tau_new = eta[None, :] + r[:, 0]
        gamma_new = alpha[None, :, :] + xi_sum
        delta = l2norm((gamma_new - gamma).reshape(gamma.shape[0], -1))
        upd = active[:, None]
        return (torch.where(upd, tau_new, tau), torch.where(upd[..., None], gamma_new, gamma),
                active & (delta >= vtol))

    tau, gamma, _ = masked_fixpoint(body, (tau, gamma, doc_mask > 0), viter)
    p0, A = _tilde(tau, gamma)
    a, _, c = split_forward(p0, A, Bv, tmask)
    r, _ = split_combine(a, c, split_backward(A, Bv, tmask, 0.0)[0], A, Bv, tmask)
    return tau, gamma, r


def split_logz_of(betaT_eps, terms, tmask, tau, gamma):
    """JAX ``_forward``'s third output in the split kernel's form
    (:func:`split_logz`)."""
    p0, A = _tilde(tau, gamma)
    Bv = betaT_eps[terms]
    return split_logz(*split_forward(p0, A, Bv, tmask), *split_backward(A, Bv, tmask, 1.0), tmask)



def _chunk(L, seed):
    """One chunk of documents of L slots, row by row: every slot real; no
    real slot; one token; a padded first slot; the midpoint (last // 2) on
    padding; tokens but doc_mask 0; a random length with interior padding;
    and every slot real with term 0, whose emission is EPSILON in every
    topic, at the last slot and at the midpoint."""
    r = np.random.default_rng(seed)
    B = 8
    tm_ = np.zeros((B, L))
    tm_[0] = 1.0
    tm_[2, 0] = 1.0
    tm_[3, 1:] = 1.0
    tm_[4] = 1.0
    tm_[4, (L - 1) // 2] = 0.0 if L > 1 else 1.0
    tm_[5] = 1.0
    tm_[6, : r.integers(1, L + 1)] = 1.0
    tm_[6, r.random(L) < 0.3] = 0.0
    tm_[7] = 1.0
    terms = r.integers(1, V, size=(B, L)).astype(np.int32)
    terms[7, -1] = terms[7, (L - 1) // 2] = 0
    terms = terms * (tm_ > 0)
    doc_mask = np.ones(B)
    doc_mask[5] = 0.0
    beta = r.dirichlet(np.ones(V - 1), size=K)
    betaT = np.concatenate([np.zeros((1, K)), beta.T]) + jax_hmtm.EPSILON
    return dict(betaT_eps=betaT, terms=terms, tmask=tm_, doc_mask=doc_mask,
                eta=r.uniform(0.5, 2.0, K), alpha=r.uniform(0.5, 2.0, (K, K)),
                tau=r.uniform(0.5, 3.0, (B, K)), gamma=r.uniform(0.5, 3.0, (B, K, K)))


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-10, atol=1e-13,
                               err_msg=what)


@pytest.mark.parametrize("viter", [0, 1, 10])
@pytest.mark.parametrize("L", [1, 2, 3, 64, 65])
def test_split_estep_and_logz_match_jax_at_the_edges(L, viter):
    x = _chunk(L, seed=100 * L + viter)
    j = {k: jnp.asarray(v) for k, v in x.items()}
    t = {k: torch.as_tensor(v) for k, v in x.items()}
    vtol = 1e-3
    jt, jg, _, _, _ = jax_hmtm._estep_chunk(
        j["betaT_eps"], j["eta"], j["alpha"], j["terms"], j["tmask"], j["doc_mask"], j["tau"],
        j["gamma"], viter, vtol, V)
    for form, estep, logz_of in (("split", split_estep, split_logz_of),
                                 ("plain", hmtm_estep_ref, hmtm_logz_ref)):
        tau, gamma, r = estep(t["betaT_eps"], t["terms"], t["tmask"], t["doc_mask"], t["eta"],
                              t["alpha"], t["tau"], t["gamma"], viter=viter, vtol=vtol)
        _close(tau, jt, f"{form} tau")
        _close(gamma, jg, f"{form} gamma")
        p0, A = jax_hmtm._tilde(jnp.asarray(tau.numpy()), jnp.asarray(gamma.numpy()))
        Bv = j["betaT_eps"][j["terms"]]
        a, c, logz = jax_hmtm._forward(p0, A, Bv, j["tmask"])
        _, _, jr = jax_hmtm._backward_stats(a, c, A, Bv, j["tmask"], with_r=True)
        _close(r, jr, f"{form} r")
        z = logz_of(t["betaT_eps"], t["terms"], t["tmask"], tau, gamma)
        _close(z, logz, f"{form} logZ")
        assert torch.all(r[t["tmask"] == 0] == 0)
        assert float(z[1]) == 0.0 and torch.all(r[1] == 0)   # the empty document
        assert torch.equal(tau[5], t["tau"][5]) and torch.equal(gamma[5], t["gamma"][5])
        if viter == 0:
            assert torch.equal(tau, t["tau"]) and torch.equal(gamma, t["gamma"])
        # the EPSILON emission moves the posteriors' sum off 1 exactly as JAX's
        _close(r[7].sum(-1), np.asarray(jr)[7].sum(-1), f"{form} r's sum on the EPSILON row")
