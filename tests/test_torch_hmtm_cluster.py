"""The cluster schedule of HMTM's E-step and normaliser against the JAX
package, on CPU, in float64.

Past the shared-memory modes, the kernels of ``kernels/csrc/hmtm_estep.cu``
run a document on a thread-block cluster of c CTAs, CTA r holding rows
[r Kr, r Kr + Kr) of A (Kr = ceil(K / c)).  The functions below are that
schedule's arithmetic as torch, one document at a time: the chain over
entries (slot 0, then each real slot after it), each CTA's rows of the
forward's raw f_k = B_k o (A f_{k-1}) / c_{k-1} gathered into the whole
message, c_k summed over the whole f_k; the backward's partials (A^T g_k)
over each CTA's rows folded in rank order, each step's g kept; S formed
once a pass on each CTA's rows from the kept g in the backward's order;
the column sums of gamma, tau and |dgamma|^2 folded in rank order between
passes.  They are held to JAX ``_estep_chunk`` and
``_forward``'s logZ at 1e-10 at K = 240 and 300 on clusters of 2, 4 and
8, on documents with a padded first slot, no real slot, one token,
interior padding, doc_mask 0 and slots whose emission is EPSILON in every
topic.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from topicmodelsvb_jl_tpu.models import hmtm as jax_hmtm
from topicmodelsvb_jl_torch.utils.numerics import EPSILON

V, B, L = 40, 8, 9


def fold(parts):
    """sum_r parts[r] in rank order, from 0, as the kernels fold them."""
    s = 0.0
    for p in parts:
        s = s + p
    return s


def blocks(K, c):
    """Each CTA's rows [i0, i1)."""
    Kr = -(-K // c)
    return [(min(r * Kr, K), min(r * Kr + Kr, K)) for r in range(c)]


def build(gamma, rows):
    """A's row blocks: exp(psi(gamma) - psi(column sums)), the column sums
    each CTA's partial over its rows, folded in rank order."""
    cs = fold([gamma[i0:i1].sum(0) for i0, i1 in rows])
    return [torch.exp(torch.special.digamma(gamma[i0:i1]) - torch.special.digamma(cs))
            for i0, i1 in rows]


def forward(Ab, rows, betaT, term, m0, p0):
    """The forward over the entries: the messages a_k, scalers c_k and logZ."""
    f = p0 * betaT[term[0]] if m0 > 0 else p0
    c = torch.sum(f) + EPSILON
    msgs, cs, logz = [f / c], [c if m0 > 0 else 1.0], torch.log(c) if m0 > 0 else 0.0
    for t in term[1:]:
        f = torch.cat([betaT[t, i0:i1] * ((A @ f) / c) for A, (i0, i1) in zip(Ab, rows)])
        c = torch.sum(f) + EPSILON
        msgs.append(f / c)
        cs.append(c)
        logz = logz + torch.log(c)
    return msgs, cs, logz


def backward(Ab, rows, betaT, term, slot, msgs, cs, r):
    """The backward over the entries: be_0 on each CTA's rows and each
    step's g on them (the g store), or the rows of r written."""
    be = [torch.ones(i1 - i0, dtype=torch.float64) for i0, i1 in rows]
    gs = {}
    for k in range(len(term) - 1, 0, -1):
        g = [betaT[term[k], i0:i1] * be[q] / cs[k] for q, (i0, i1) in enumerate(rows)]
        gs[k] = g
        if r is not None:
            r[slot[k]] = torch.cat([msgs[k][i0:i1] * be[q] for q, (i0, i1) in enumerate(rows)])
        total = fold([A.T @ gq for A, gq in zip(Ab, g)])
        be = [total[i0:i1] for i0, i1 in rows]
    return be, gs


def stat(gs, msgs, rows, K):
    """S on each CTA's rows, formed once a pass from the g store: the sum
    over entries k = ne - 1 .. 1 of g_k a_{k-1}^T, in the backward's order."""
    S = [torch.zeros(i1 - i0, K, dtype=torch.float64) for i0, i1 in rows]
    for k in sorted(gs, reverse=True):
        for Sq, gq in zip(S, gs[k]):
            Sq += torch.outer(gq, msgs[k - 1])
    return S


def p0_of(tau):
    return torch.exp(torch.special.digamma(tau) - torch.special.digamma(torch.sum(tau)))


def cluster_doc(betaT, terms, tmask, dm, eta, alpha, tau, gamma, viter, vtol, c):
    """One document's E-step and its logZ at the final state, in the
    cluster schedule on c CTAs."""
    K = tau.shape[0]
    rows = blocks(K, c)
    slot = [0] + [n for n in range(1, tmask.shape[0]) if tmask[n] > 0]
    term = [int(terms[n]) for n in slot]
    m0 = float(tmask[0])
    gamma, tau = gamma.clone(), tau.clone()
    Ab = build(gamma, rows)
    active = dm > 0
    for _ in range(viter):
        if not active:
            break
        msgs, cs, _ = forward(Ab, rows, betaT, term, m0, p0_of(tau))
        be, gs = backward(Ab, rows, betaT, term, slot, msgs, cs, None)
        Sb = stat(gs, msgs, rows, K)
        tau = torch.cat([eta[i0:i1] + msgs[0][i0:i1] * be[q] * m0
                         for q, (i0, i1) in enumerate(rows)])
        new = [alpha[i0:i1] + A * S for A, S, (i0, i1) in zip(Ab, Sb, rows)]
        d2 = fold([torch.sum((gn - gamma[i0:i1]) ** 2) for gn, (i0, i1) in zip(new, rows)])
        gamma = torch.cat(new)
        Ab = build(gamma, rows)
        active = bool(torch.sqrt(d2) >= vtol)
    msgs, cs, _ = forward(Ab, rows, betaT, term, m0, p0_of(tau))
    r = torch.zeros(tmask.shape[0], K, dtype=torch.float64)
    be, _ = backward(Ab, rows, betaT, term, slot, msgs, cs, r)
    r[0] = torch.cat([msgs[0][i0:i1] * be[q] * m0 for q, (i0, i1) in enumerate(rows)])
    logz = forward(Ab, rows, betaT, term, m0, p0_of(tau))[2]
    return tau, gamma, r, logz


def _chunk(K, seed):
    """Rows: every slot real; a padded first slot; no real slot; one token;
    interior padding; tokens but doc_mask 0; every slot real with term 0,
    whose emission is EPSILON in every topic, at the last slot and the
    middle; a random length."""
    r = np.random.default_rng(seed)
    tm = np.zeros((B, L))
    tm[0] = 1.0
    tm[1, 1:] = 1.0
    tm[3, 0] = 1.0
    tm[4, : L - 2] = 1.0
    tm[4, [2, 3, 5]] = 0.0
    tm[5] = 1.0
    tm[6] = 1.0
    tm[7, : r.integers(2, L + 1)] = 1.0
    terms = r.integers(1, V, size=(B, L)).astype(np.int32)
    terms[6, -1] = terms[6, L // 2] = 0
    terms = terms * (tm > 0)
    doc_mask = np.ones(B)
    doc_mask[5] = 0.0
    beta = r.dirichlet(np.ones(V - 1), size=K)
    betaT = np.concatenate([np.zeros((1, K)), beta.T]) + jax_hmtm.EPSILON
    return dict(betaT_eps=betaT, terms=terms, tmask=tm, doc_mask=doc_mask,
                eta=r.uniform(0.5, 2.0, K), alpha=r.uniform(0.5, 2.0, (K, K)),
                tau=r.uniform(0.5, 3.0, (B, K)), gamma=r.uniform(0.5, 3.0, (B, K, K)))


VITER, VTOL = 3, 1e-3


@functools.lru_cache(maxsize=None)
def _jax(K):
    """The chunk and JAX's tau, gamma, r and logZ at the final state."""
    x = _chunk(K, seed=K)
    j = {k: jnp.asarray(v) for k, v in x.items()}
    tau, gamma, _, _, _ = jax_hmtm._estep_chunk(
        j["betaT_eps"], j["eta"], j["alpha"], j["terms"], j["tmask"], j["doc_mask"], j["tau"],
        j["gamma"], VITER, VTOL, V)
    p0, A = jax_hmtm._tilde(tau, gamma)
    Bv = j["betaT_eps"][j["terms"]]
    a, c, logz = jax_hmtm._forward(p0, A, Bv, j["tmask"])
    _, _, r = jax_hmtm._backward_stats(a, c, A, Bv, j["tmask"], with_r=True)
    return x, tuple(np.asarray(v) for v in (tau, gamma, r, logz))


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-10, atol=1e-13,
                               err_msg=what)


@pytest.mark.parametrize("c", [2, 4, 8])
@pytest.mark.parametrize("K", [240, 300])
def test_cluster_schedule_matches_jax(K, c):
    x, (jt, jg, jr, jz) = _jax(K)
    t = {k: torch.as_tensor(v) for k, v in x.items()}
    for d in range(B):
        tau, gamma, r, logz = cluster_doc(
            t["betaT_eps"], t["terms"][d], t["tmask"][d], float(t["doc_mask"][d]), t["eta"],
            t["alpha"], t["tau"][d], t["gamma"][d], VITER, VTOL, c)
        _close(tau, jt[d], f"doc {d} tau")
        _close(gamma, jg[d], f"doc {d} gamma")
        _close(r, jr[d], f"doc {d} r")
        _close(logz, jz[d], f"doc {d} logZ")
        assert torch.all(r[t["tmask"][d] == 0] == 0)
    # the empty document's logZ is exactly 0; doc_mask 0 keeps the state
    assert float(cluster_doc(t["betaT_eps"], t["terms"][2], t["tmask"][2], 1.0, t["eta"],
                             t["alpha"], t["tau"][2], t["gamma"][2], VITER, VTOL, c)[3]) == 0.0
    masked = cluster_doc(t["betaT_eps"], t["terms"][5], t["tmask"][5], 0.0, t["eta"], t["alpha"],
                         t["tau"][5], t["gamma"][5], VITER, VTOL, c)
    assert torch.equal(masked[0], t["tau"][5]) and torch.equal(masked[1], t["gamma"][5])
    # row 6 is the EPSILON case: its last slot's posteriors sum below 1
    assert jr[6].sum(-1)[-1] < 0.99
