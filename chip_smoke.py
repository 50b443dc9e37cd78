"""Drive the PyTorch port's LDA, fLDA, CTPF, CTM and fCTM main paths once on one CUDA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA Hopper GPU
(the kernels are built for sm_90a) and the CUDA toolkit.  Phases, each
printing its own lines; any failure exits non-zero:

1. the card's name and power limit, then the kernels' build from
   ``topicmodelsvb_jl_torch/kernels/csrc`` (one nvcc per source, in
   parallel) and its time;
2. the corpora: the synthetic NSF-scale corpus (128,804 docs, V = 25,319,
   seed 7), bucketized as ``LDA``/``fLDA`` do (chunk 1024, width multiple
   8), and the synthetic CiteULike-scale corpus (16,980 docs, V = 8,000,
   U = 5,551, seed 7) packed with its readers, with its host time;
3. each kernel against its plain PyTorch version on the card at K = 100:
   one 1024-document chunk of the widest bucket (of the CiteULike corpus
   for CTPF) and one synthetic chunk whose rows do not fit shared memory;
   the M-step scatter on the real rows of those chunks (LDA W = 100, fLDA
   W = 101, CTPF's term and reader scatters), on a chunk whose rows are
   all one id and on an empty chunk; each kernel's device time (CUDA
   events around 20 launches queued behind a spin kernel, so no host gap
   is counted), its call time (the host clock around 20 calls, up to a
   synchronize), its plain version's, its bound (bytes over the HBM rate
   or f32 operations over the f32 rate, whichever is larger, counted from
   these inputs) and, for the scatter, ``index_add_`` over all rows, the
   one PyTorch call that computes the same sums (a yardstick the port
   never calls); each kernel twice, bitwise equal; then, for each family,
   a small model trained on the card (f32, kernels) and on the CPU (f64,
   plain versions) from one init;
4. the main paths, each with its kernels' launch counts set to 0 just
   before and read just after: ``LDA`` and ``fLDA`` at NSF scale and
   ``CTPF`` at CiteULike scale, K = 100, ``train(iter=4, checkelbo=1)``;
   ``CTM`` and ``fCTM`` at NSF scale, K = 50, 2048-document chunks, the
   same ``train``: ∆elbo > 0, ``check_model`` passes, every chunk of every
   step went through each kernel of the path, and the times; then, on the
   first chunk of the widest bucket of the trained CTM and fCTM, the
   scatter on the rows of their E-step (W = 50, 51) and ``lda_elbo_tok``
   on CTM's bound tables (the raw beta_old), as they are and with the
   chunk's zero-count slots at an id whose beta_old row is exact zeros,
   against their plain versions;
5. for each family, two fresh same-seed models, one step each, bitwise
   equal in the global parameters and the per-document state;
6. the Corpus path, through the entry points a user calls, with the launch
   counts set to 0 before each step and read after: ``load_nsf`` (32,768
   documents, the full width) through ``writecorp``/``readcorp`` (which
   parser ran) and ``fixcorp``; ``LDA(train, 100)`` with no ``device=``,
   trained as in phase 4; ``showtopics``; ``predict`` on 1,024 held-out
   documents (against ``predict`` on the CPU in f64 from the same state)
   and on 50; ``perplexity``, ``topic_coherence``, ``gencorp`` and one step
   on what it drew; ``predict`` on an fLDA; then ``load_citeu``, held-out
   readers, an LDA and a CTPF warm-started from it, its displays, the
   held-out readers' ranks and recall; each step's time;
7. the scatter against ``index_add_`` on every shape; one JSON line with
   every kernel's launches, largest error, device and call times, plain
   version's time, bound (``bound_ms``, ``bound_by``) and library call's
   time (``library_ms``, null where no PyTorch call computes the same
   function), each at its main path's widest chunk; the card again; and
   last ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import ctypes
import io
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

RTOL, ATOL = 5e-3, 1e-5   # the JAX package's Pallas-vs-XLA tolerance in f32
ROOT = os.path.dirname(os.path.abspath(__file__))
# NVIDIA's H100 SXM data sheet: the HBM rate and
# the f32 rate outside the tensor cores, at the full 700 W power limit
HBM_BYTES_PER_S, F32_FLOPS = 3.35e12, 67e12
# ex2 results a second: 16 a clock an SM (the CUDA C++ Programming Guide's
# throughput table, compute capability 9.0), 132 SMs at the 1.98 GHz boost
EX2_PER_S = 16 * 132 * 1.98e9
SPIN_CYCLES_PER_MS = 2.0e6  # torch.cuda._sleep cycles a ms at ~2 GHz
N_KERNEL, N_PLAIN = 20, 5   # calls between one pair of events


def need(cond, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def time_calls(fn, n: int = 20, reps: int = 3) -> tuple:
    """(device ms, call ms) of one call of ``fn``, after two warm-up calls.

    Call time: the host clock around ``n`` back-to-back calls, ended by a
    synchronize, over ``n``: what a caller waits per call in a loop.
    Device time: CUDA events around ``n`` calls queued behind a spin
    kernel (``torch.cuda._sleep``) that lasts longer than the host takes
    to enqueue them, so the device runs them back to back and no host gap
    is counted; the median of ``reps`` such runs, over ``n``.  A function
    that reads a value back to the host (the plain versions' fixpoints)
    waits out the spin and its device time counts its host gaps."""
    import torch

    fn()
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    call_ms = (time.perf_counter() - t0) * 1e3 / n
    spin = int(SPIN_CYCLES_PER_MS * (1.5 * call_ms * n + 1.0))
    dev = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        dev.append(start.elapsed_time(end) / n)
    return statistics.median(dev), call_ms


def bound_ms(nbytes: float, flops: float) -> tuple:
    """The least time the card could take for work that moves ``nbytes``
    (each input read once, each output written once) and does ``flops``
    f32 operations outside the tensor cores: (ms, "bytes" or "operations")."""
    tb, tf = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return max(tb, tf) * 1e3, ("bytes" if tb >= tf else "operations")


def fixpoint_work(module, ref, args, kw, per_doc) -> float:
    """Sum over the passes of the plain version's fixpoint of ``per_doc``
    [B] for the documents still active in each pass: the passes the data
    needs, read from the plain version's own loop (``masked_fixpoint``,
    whose carry ends in the active mask)."""
    total = 0.0
    orig = module.masked_fixpoint

    def counting(body, carry, viter, *a, **k):
        def counted(i, c):
            nonlocal total
            total += float((c[-1].to(per_doc.dtype) * per_doc).sum())
            return body(i, c)
        return orig(counted, carry, viter, *a, **k)

    module.masked_fixpoint = counting
    try:
        ref(*args, **kw)
    finally:
        module.masked_fixpoint = orig
    return total


def n_unique(ids, keep) -> int:
    """Distinct ids among the kept slots: the table rows a kernel must read."""
    import torch

    return int(torch.unique(ids[keep]).numel())


def close(got, want, names, label) -> float:
    """Every output finite and within RTOL/ATOL of the plain version;
    returns the largest absolute difference."""
    import torch

    err = 0.0
    for name, a, b in zip(names, got, want):
        need(bool(torch.all(torch.isfinite(a))), f"{label}: {name} not finite")
        excess = (a - b).abs() - (ATOL + RTOL * b.abs())
        need(float(excess.max()) <= 0.0,
             f"{label}: {name} off by {float((a - b).abs().max())}")
        err = max(err, float((a - b).abs().max()))
    return err


def padded_kept(got, inputs, rows, doc_mask, label) -> None:
    """Padded documents keep their state bit for bit and get zero rows
    (the synthetic chunks end in 3 of them)."""
    import torch

    pad = doc_mask == 0
    for a, b in zip(got, inputs):
        need(torch.equal(a[pad], b[pad]), f"{label}: a padded document's state moved")
    for w in rows:
        need(bool(torch.all(w[pad] == 0)), f"{label}: a padded document got rows")


def warm_state(K, B, dev, seed):
    """A converging per-document state: gamma > alpha, El = E[log theta]."""
    import torch

    g = torch.Generator().manual_seed(seed)
    alpha = 0.2 + 1.3 * torch.rand(K, generator=g)
    gamma = alpha + 0.1 + 5.0 * torch.rand(B, K, generator=g)
    El = torch.special.digamma(gamma) - torch.special.digamma(gamma.sum(-1, keepdim=True))
    El_old = El + 0.05 * torch.randn(B, K, generator=g)
    return [t.to(dev).contiguous() for t in (alpha, gamma, El, El_old)]


def record(err, timed, plain, bnd, library=None) -> dict:
    """One kernel at one shape: its error against the plain version, its
    device and call times, the plain version's, its bound and, for the
    scatter, the library call's (device ms, call ms)."""
    return {"max_abs_err": err, "ms": timed[0], "call_ms": timed[1], "plain_ms": plain[0],
            "plain_call_ms": plain[1], "bound_ms": bnd[0], "bound_by": bnd[1],
            "library_ms": None if library is None else library[0],
            "library_call_ms": None if library is None else library[1]}


def times(r) -> str:
    out = (f"{r['ms']:.4f} ms device, {r['call_ms']:.4f} ms a call (plain {r['plain_ms']:.4f}; "
           f"bound {r['bound_ms']:.4f} ms by {r['bound_by']}")
    if r["library_ms"] is not None:
        out += f"; library {r['library_ms']:.4f} ms device, {r['library_call_ms']:.4f} a call"
    return out + f"; max abs err {r['max_abs_err']:.3e})"


def compare_kernels(seg, V, K, dev, label):
    """Both LDA kernels against their plain versions on one chunk."""
    import torch

    from topicmodelsvb_jl_torch.kernels import lda_estep as estep_mod
    from topicmodelsvb_jl_torch.kernels.lda_elbo import lda_elbo_tok, lda_elbo_tok_ref
    from topicmodelsvb_jl_torch.kernels.lda_estep import lda_estep, lda_estep_ref
    from topicmodelsvb_jl_torch.utils.numerics import EPSILON, dirichlet_ones

    terms, counts, doc_mask = seg
    B, L = terms.shape
    g = torch.Generator().manual_seed(11)
    beta = dirichlet_ones(g, V, (K,)).to(dev)
    beta_old = dirichlet_ones(g, V, (K,)).to(dev)
    betaT = (beta + EPSILON).T.contiguous()
    alpha, gamma, El, El_old = warm_state(K, B, dev, seed=12)
    args = (betaT, terms, counts, doc_mask, alpha, gamma, El, El_old)
    kw = dict(viter=10, vtol=1.0 / K**2)

    got = lda_estep(*args, **kw)
    want = lda_estep_ref(*args, **kw)
    torch.cuda.synchronize()
    err_e = close(got, want, ("gamma", "El", "El_old", "w"), f"lda_estep {label}")
    need(bool(torch.all(got[3][doc_mask == 0] == 0)), f"lda_estep {label}: padded w")
    again = lda_estep(*args, **kw)
    need(all(torch.equal(a, b) for a, b in zip(got, again)),
         f"lda_estep {label}: not bitwise repeatable")
    keep = counts > 0
    kept = int(keep.sum())
    work = fixpoint_work(estep_mod, lda_estep_ref, args, kw, keep.sum(1).float())
    uniq = n_unique(terms, keep)
    est = record(err_e, time_calls(lambda: lda_estep(*args, **kw), N_KERNEL),
                 time_calls(lambda: lda_estep_ref(*args, **kw), N_PLAIN, reps=1),
                 bound_ms(4 * (uniq * K + 2 * B * L + B + K + 6 * B * K + B * L * K),
                          4 * K * work + 2 * K * kept))

    boT = (beta_old + EPSILON).T.contiguous()
    g2T = (boT * (torch.log(beta + EPSILON).T - torch.log(boT))).contiguous()
    eargs = (boT, g2T, terms, counts, doc_mask, El, El_old)
    got_e = lda_elbo_tok(*eargs)
    need(torch.equal(got_e, lda_elbo_tok(*eargs)), f"lda_elbo_tok {label}: not bitwise repeatable")
    a, b = float(got_e), float(lda_elbo_tok_ref(*eargs))
    need(abs(a - b) <= 1e-5 * abs(b), f"lda_elbo_tok {label}: {a} vs {b}")
    elb = record(abs(a - b), time_calls(lambda: lda_elbo_tok(*eargs), N_KERNEL),
                 time_calls(lambda: lda_elbo_tok_ref(*eargs), N_PLAIN, reps=1),
                 bound_ms(4 * (2 * uniq * K + 2 * B * L + 2 * B + 2 * B * K), 6 * K * kept))
    print(f"kernels {label}: B={B} L={L} K={K} kept={kept} passes a kept slot "
          f"{work / max(kept, 1):.2f} | lda_estep {times(est)} | lda_elbo_tok {times(elb)}, rel err "
          f"{abs(a - b) / abs(b):.3e}")
    return dict(estep=est, elbo=elb, w=got[3])


def compare_flda(seg, V, K, dev, label):
    """flda_estep against its plain version on one chunk."""
    import torch

    from topicmodelsvb_jl_torch.kernels import flda_estep as flda_mod
    from topicmodelsvb_jl_torch.kernels.flda_estep import flda_estep, flda_estep_ref
    from topicmodelsvb_jl_torch.utils.numerics import EPSILON, dirichlet_ones

    terms, counts, doc_mask = seg
    B, L = terms.shape
    g = torch.Generator().manual_seed(21)
    logbetaT = torch.log(dirichlet_ones(g, V, (K,)) + EPSILON).T.contiguous().to(dev)
    kappa = dirichlet_ones(g, V).to(dev)
    tau, tau_old = (0.1 + 0.8 * torch.rand(B, L, generator=g)).to(dev), \
        (0.1 + 0.8 * torch.rand(B, L, generator=g)).to(dev)
    alpha, gamma, El, El_old = warm_state(K, B, dev, seed=22)
    eta = torch.tensor(0.6, device=dev)
    args = (logbetaT, kappa, terms, counts, doc_mask, alpha, eta, gamma, El, El_old,
            tau, tau_old)
    kw = dict(viter=10, vtol=1.0 / K**2)
    got = flda_estep(*args, **kw)
    want = flda_estep_ref(*args, **kw)
    torch.cuda.synchronize()
    err = close(got, want, ("gamma", "El", "El_old", "tau", "tau_old", "w"),
                f"flda_estep {label}")
    padded_kept(got[:5], (gamma, El, El_old, tau, tau_old), got[5:], doc_mask,
                f"flda_estep {label}")
    need(all(torch.equal(a, b) for a, b in zip(got, flda_estep(*args, **kw))),
         f"flda_estep {label}: not bitwise repeatable")
    keep = counts > 0
    kept = int(keep.sum())
    work = fixpoint_work(flda_mod, flda_estep_ref, args, kw, keep.sum(1).float())
    # every slot of an active document, padding included, takes K exps a pass
    exps = K * fixpoint_work(flda_mod, flda_estep_ref, args, kw,
                             torch.full((B,), float(L), device=dev))
    uniq = n_unique(terms, keep)
    r = record(err, time_calls(lambda: flda_estep(*args, **kw), N_KERNEL),
               time_calls(lambda: flda_estep_ref(*args, **kw), 3, reps=1),
               bound_ms(4 * (uniq * (K + 1) + 4 * B * L + B + K + 1 + 6 * B * K + 2 * B * L
                             + B * L * (K + 1)), 4 * K * work + 2 * (K + 1) * kept))
    r["exp_floor_ms"] = exps / EX2_PER_S * 1e3
    print(f"kernels {label}: B={B} L={L} K={K} | flda_estep {times(r)}; exp floor "
          f"{r['exp_floor_ms']:.4f} ms ({exps:.3e} ex2)")
    return r, got[5]


def ctpf_args(tok, rd, V, U, K, dev):
    """``ctpf_estep``'s arguments and keywords on one chunk: random
    exp(ψ) tables [V, K] and [U, K], hyperparameter vectors and state
    (seed 31), viter 10."""
    import torch

    terms, counts, doc_mask = tok
    readers, ratings = rd
    B = terms.shape[0]
    g = torch.Generator().manual_seed(31)
    gam = lambda *shape: 0.1 + 3.0 * torch.rand(*shape, generator=g)
    ealefT = torch.exp(torch.special.digamma(gam(K, V))).T.contiguous().to(dev)
    eheT = torch.exp(torch.special.digamma(gam(K, U))).T.contiguous().to(dev)
    dalet, bet, vav, het = (0.5 + 2.5 * torch.rand(K, generator=g) for _ in range(4))
    inv = [(1.0 / x).to(dev) for x in (dalet * bet, dalet * vav, het * vav)]
    state = [gam(B, K).to(dev) for _ in range(4)]
    args = (ealefT, eheT, terms, counts, readers, ratings, doc_mask, *inv, *state)
    return args, dict(viter=10, vtol=1.0 / K**2, c_hyper=0.1, g_hyper=0.1)


def compare_ctpf(tok, rd, V, U, K, dev, label):
    """ctpf_estep against its plain version on one chunk."""
    import torch

    from topicmodelsvb_jl_torch.kernels import ctpf_estep as ctpf_mod
    from topicmodelsvb_jl_torch.kernels.ctpf_estep import ctpf_estep, ctpf_estep_ref

    terms, counts, doc_mask = tok
    readers, ratings = rd
    B, L = terms.shape
    R = readers.shape[1]
    args, kw = ctpf_args(tok, rd, V, U, K, dev)
    got = ctpf_estep(*args, **kw)
    want = ctpf_estep_ref(*args, **kw)
    torch.cuda.synchronize()
    err = close(got, want, ("gimel", "gimel_old", "zayin", "zayin_old", "wa", "wh"),
                f"ctpf_estep {label}")
    padded_kept(got[:4], args[10:], got[4:], doc_mask, f"ctpf_estep {label}")
    need(all(torch.equal(a, b) for a, b in zip(got, ctpf_estep(*args, **kw))),
         f"ctpf_estep {label}: not bitwise repeatable")
    kt, kr = counts > 0, ratings > 0
    kept = int(kt.sum()) + int(kr.sum())
    work = fixpoint_work(ctpf_mod, ctpf_estep_ref, args, kw, (kt.sum(1) + kr.sum(1)).float())
    r = record(err, time_calls(lambda: ctpf_estep(*args, **kw), N_KERNEL),
               time_calls(lambda: ctpf_estep_ref(*args, **kw), 3, reps=1),
               bound_ms(4 * ((n_unique(terms, kt) + n_unique(readers, kr)) * K
                             + 2 * B * (L + R) + B + 3 * K + 8 * B * K + B * (L + R) * K),
                        4 * K * work + 2 * K * kept))
    print(f"kernels {label}: B={B} L={L} R={R} K={K} kept={kept} passes a kept slot "
          f"{work / max(kept, 1):.2f} | ctpf_estep {times(r)}")
    return r, got[4], got[5]


def compare_scatter(V, w, ids, keep, dev, label):
    """scatter_rows against its plain version on one chunk's rows [T, W];
    also times ``index_add_`` over all T rows, the one PyTorch call that
    computes the same sums (atomic on the card, so a yardstick only)."""
    import torch

    from topicmodelsvb_jl_torch.kernels.scatter_rows import (
        build_plan, scatter_rows, scatter_rows_ref,
    )

    ids, keep = ids.reshape(-1), keep.reshape(-1)
    plan = build_plan(ids.cpu().numpy(), keep.cpu().numpy()).to(dev)
    W = w.shape[1]
    acc = torch.rand((V, W), device=dev)
    n0 = scatter_rows.launches
    got = scatter_rows(acc.clone(), w, plan)
    want = scatter_rows_ref(acc.clone(), w, plan)
    torch.cuda.synchronize()
    need(scatter_rows.launches == n0 + (plan.n_pieces > 0), f"scatter_rows {label}: launches")
    err = close([got], [want], ["acc"], f"scatter_rows {label}")
    need(torch.equal(got, scatter_rows(acc.clone(), w, plan)),
         f"scatter_rows {label}: not bitwise repeatable")
    need(bool(torch.all(w[~keep] == 0)), f"scatter_rows {label}: a left-out row is not 0")
    ids_l = ids.long()
    kept, uniq = plan.rows.shape[0], n_unique(ids, keep)
    r = record(err, time_calls(lambda: scatter_rows(acc, w, plan), N_KERNEL),
               time_calls(lambda: scatter_rows_ref(acc, w, plan), N_KERNEL),
               bound_ms(4 * (kept * W + kept + 3 * plan.n_pieces + 2 * uniq * W), kept * W),
               time_calls(lambda: acc.index_add_(0, ids_l, w), N_KERNEL))
    print(f"scatter {label}: T={plan.T} kept={kept} W={W} pieces={plan.n_pieces} "
          f"split runs={plan.run_id.shape[0]} | scatter_rows {times(r)}")
    r["label"] = label
    return r


def card_vs_cpu(name, make, to_np, from_np, fields, dev) -> None:
    """A small model trained 3 iterations on the card (f32, kernels) and
    on the CPU (f64, plain versions) from one init."""
    import numpy as np
    import torch

    import topicmodelsvb_jl_torch as tt

    gpu = make(tt.RuntimeConfig(chunk_docs=256), dev)
    cpu = make(tt.RuntimeConfig(chunk_docs=256, dtype="float64"), "cpu")
    cpu.state = from_np(to_np(gpu.state), "cpu", torch.float64)
    gpu.train(iter=3, checkelbo=1, printelbo=False)
    cpu.train(iter=3, checkelbo=1, printelbo=False)
    ge = [x.elbo for x in gpu.trainer.trace]
    ce = [x.elbo for x in cpu.trainer.trace]
    rel = max(abs(a - b) / abs(b) for a, b in zip(ge, ce))
    need(rel <= 1e-4, f"small {name}: f32 card ELBO {ge} vs f64 CPU {ce}")
    worst = 0.0
    for f in fields:
        a, b = np.asarray(getattr(gpu, f), np.float64), np.asarray(getattr(cpu, f))
        need(np.allclose(a, b, rtol=1e-3, atol=1e-6), f"small {name}: {f}")
        worst = max(worst, float(np.max(np.abs(a - b) / (1e-6 + np.abs(b)))))
    print(f"small {name} (M={gpu.M}, K={gpu.K}, 3 iterations): card f32 vs CPU f64 "
          f"ELBO rel diff {rel:.3e}, worst parameter rel diff {worst:.3e} "
          f"({', '.join(fields)})")


def main_path(model, label, expect, smi, monotone_from=0, pure_steps=3):
    """Train 4 iterations with checkelbo=1 with the launch counts zeroed
    just before; checks and prints; returns the counts.

    ``expect`` maps each kernel of the path to its launches (per step,
    per ELBO pass), given the model and its chunk count."""
    import torch

    from topicmodelsvb_jl_torch.validate import check_model

    for k in expect:
        k.launches = 0
    t0 = time.perf_counter()
    model.train(iter=4, checkelbo=1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in expect}
    trace = model.trainer.trace
    deltas = [x.delta_elbo for x in trace]
    need(len(trace) == 4, f"{label}: ran {len(trace)} of 4 iterations")
    need(all(d > 0 for d in deltas[monotone_from:]), f"{label}: ∆elbo not positive: {deltas}")
    check_model(model)
    n_chunks = n_chunks_of(model)
    for k, rule in expect.items():
        per_step, per_elbo = rule(model, n_chunks)
        want = per_step * len(trace) + per_elbo * (len(trace) + 1)
        need(launches[k.__name__] == want,
             f"{label}: {k.__name__} launches {launches[k.__name__]} != {want}")
    step_s = statistics.median(x.step_time_s for x in trace[1:])
    tr = model.trainer
    state = model.state
    pure = []
    for _ in range(pure_steps):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state = tr.step_fn(state, *tr.data)
        torch.cuda.synchronize()
        pure.append(time.perf_counter() - t1)
    elbo_ms = time_calls(lambda: tr.elbo_fn(state, *tr.elbo_data), 3, reps=1)[0]
    M = model.M
    print(f"main path {label}: M={M} K={model.K} chunks={n_chunks} 4 iterations in "
          f"{wall:.2f} s; first ∆elbo {deltas[0]:.3f}; median step+ELBO {step_s:.4f} s = "
          f"{M / step_s:.0f} docs/s; step alone {statistics.median(pure):.4f} s = "
          f"{M / statistics.median(pure):.0f} docs/s; ELBO pass {elbo_ms:.2f} ms; "
          f"final elbo {model.elbo:.3f}; launches {launches}; peak mem "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; card {smi}")
    return launches


def same_seed_steps(make, fields, label) -> None:
    """Two fresh same-seed models, one step each, bitwise equal."""
    import torch

    runs = []
    for _ in range(2):
        m = make()
        m.train(iter=1, checkelbo=float("inf"), printelbo=False)
        runs.append(m.state)
    for f in fields:
        need(torch.equal(getattr(runs[0], f), getattr(runs[1], f)),
             f"{label}: same-seed steps differ in {f}")
    print(f"determinism {label}: two same-seed steps bitwise equal in {', '.join(fields)}")


def n_chunks_of(model) -> int:
    return sum(s.terms.shape[0] for s in model.packed.segments) // model.chunk_docs


def scatters_of(model, readers: bool = False) -> int:
    """Scatter launches per step: one per chunk with a count > 0 and, with
    ``readers`` (CTPF), one more per chunk with a rating > 0."""
    import numpy as np

    p, n = model.packed, 0
    for s in p.segments:
        B = min(model.chunk_docs, s.terms.shape[0])
        for lo in range(0, s.terms.shape[0], B):
            n += bool(np.any(s.counts[lo:lo + B] > 0))
            if readers:
                n += bool(np.any(p.ratings[s.loc_start + lo:s.loc_start + lo + B] > 0))
    return n


def compare_ctm_chunk(model, dev, label):
    """On the first chunk of the widest bucket of a trained CTM or fCTM:
    the scatter on the rows w of that chunk's E-step and, for CTM,
    ``lda_elbo_tok`` on the bound's tables, each against its plain version.
    Returns the scatter's and the bound's records (``record``)."""
    import torch

    from topicmodelsvb_jl_torch.kernels.lda_elbo import lda_elbo_tok, lda_elbo_tok_ref
    from topicmodelsvb_jl_torch.models import ctm as ctm_mod, fctm as fctm_mod
    from topicmodelsvb_jl_torch.utils.numerics import EPSILON

    st, K, segs = model.state, model.K, model.packed.segments
    j = max(range(len(segs)), key=lambda i: segs[i].L)
    B, L = min(model.chunk_docs, segs[j].terms.shape[0]), segs[j].L
    rows = slice(segs[j].loc_start, segs[j].loc_start + B)
    t, c, dm = (x[j][:B] for x in model.trainer.data[:3])
    kw = dict(viter=10, vtol=1.0 / K**2, niter=1000, ntol=1.0 / K**2)
    doc = (st.lam[rows], st.lam_old[rows], st.vsq[rows], st.logzeta[rows])
    if isinstance(st, fctm_mod.FCTMState):
        logbetaT = torch.log(st.beta + EPSILON).T.contiguous()
        w = fctm_mod.estep_chunk(logbetaT, st.kappa, st.eta, st.mu, st.invsigma, t, c, dm,
                                 *doc, st.tau[rows, :L], st.tau_old[rows, :L], **kw)[-1]
    else:
        logbetaT = torch.log(st.beta).T.contiguous()
        w = ctm_mod.estep_chunk(logbetaT, st.mu, st.invsigma, t, c, dm, *doc, **kw)[-1]
    sc = compare_scatter(model.V, w.reshape(B * L, -1), t, c > 0, dev,
                         f"{label} w, widest bucket B={B} L={L}")
    if isinstance(st, fctm_mod.FCTMState):
        return sc, None
    boT, g2T = ctm_mod.elbo_tables(st)
    # also the chunk with its zero-count slots pointing at an id it does not
    # use, that id's raw beta_old row exact zeros (as for a word no document
    # holds): s = 0 on those slots, which both versions must mask
    used = torch.zeros(model.V, dtype=torch.bool, device=dev)
    used[t[c > 0].long()] = True
    free = torch.nonzero(~used)
    need(free.numel() > 0, f"{label}: the chunk uses every id")
    z = int(free[0])
    boZ, g2Z = boT.clone(), g2T.clone()
    boZ[z], g2Z[z] = 0.0, 0.0
    tZ = torch.where(c > 0, t, z).to(torch.int32).contiguous()
    err = 0.0
    for tables, terms, what in (
            ((boT, g2T), t, f"beta_old with {int((boT == 0).sum())} exact zeros"),
            ((boZ, g2Z), tZ, f"zero-count slots at id {z}, its beta_old row 0")):
        eargs = (*tables, terms, c, dm, st.lam[rows], st.lam_old[rows])
        n0 = lda_elbo_tok.launches
        got_e = lda_elbo_tok(*eargs)
        need(lda_elbo_tok.launches == n0 + 1, f"lda_elbo_tok {label}: no launch")
        need(torch.equal(got_e, lda_elbo_tok(*eargs)),
             f"lda_elbo_tok {label}: not bitwise repeatable")
        a = float(got_e)
        b = float(lda_elbo_tok_ref(*eargs))
        need(math.isfinite(a) and abs(a - b) <= 1e-5 * abs(b),
             f"lda_elbo_tok {label}, {what}: {a} vs {b}")
        err = max(err, abs(a - b))
        print(f"kernels {label} bound, widest bucket: B={B} L={L} K={K}, {what} | "
              f"rel err {abs(a - b) / abs(b):.3e}")
    eargs = (boT, g2T, t, c, dm, st.lam[rows], st.lam_old[rows])
    keep = c > 0
    r = record(err, time_calls(lambda: lda_elbo_tok(*eargs), N_KERNEL),
               time_calls(lambda: lda_elbo_tok_ref(*eargs), N_PLAIN, reps=1),
               bound_ms(4 * (2 * n_unique(t, keep) * K + 2 * B * L + 2 * B + 2 * B * K),
                        6 * K * int(keep.sum())))
    print(f"kernels {label} bound: lda_elbo_tok {times(r)}")
    return sc, r


def citeulike():
    """The synthetic CiteULike-scale corpus (16,980 docs, V = 8,000, U =
    5,551, seed 7) packed with its readers, its buckets (chunk 1024, width
    multiple 8) and synth_corpus's host seconds."""
    import topicmodelsvb_jl_torch as tt

    t0 = time.perf_counter()
    citeu = tt.synth_corpus(M=16_980, V=8_000, U=5_551, K=30, seed=7, mean_tokens=60,
                            mean_terms=45, mean_readers=5)
    synth_s = time.perf_counter() - t0
    cpk = tt.pack_corpus(citeu, with_readers=True)
    return cpk, tt.bucketize_packed(cpk, chunk=1024, pad_multiple=8), synth_s


def long_chunks(V, U, dev) -> dict:
    """The synthetic 1024-document chunks whose rows do not fit shared
    memory: ``long`` (L = 1024, term ids below V, seed 3), ``long_pad``
    (the same ending in 3 padded documents) and ``ctpf_long`` (its first
    768 token slots and 256 reader slots over U users, seed 4)."""
    import numpy as np
    import torch

    put = lambda a, dt: torch.as_tensor(np.ascontiguousarray(a), dtype=dt).to(dev)
    f32, i32 = torch.float32, torch.int32
    r = np.random.default_rng(3)
    n = r.integers(600, 1025, size=1024)
    cnt = (1 + r.poisson(0.35, size=(1024, 1024))) * (np.arange(1024)[None, :] < n[:, None])
    trm = np.minimum((V * r.random((1024, 1024)) ** 3).astype(np.int32), V - 1) * (cnt > 0)
    long_ = (put(trm, i32), put(cnt, f32), torch.ones(1024, dtype=f32, device=dev))
    mask_pad = torch.ones(1024, dtype=f32, device=dev)
    mask_pad[-3:] = 0
    cnt[-3:] = 0
    long_pad = (put(trm * (cnt > 0), i32), put(cnt, f32), mask_pad)
    rr = np.random.default_rng(4)
    rat = (np.arange(256)[None, :] < rr.integers(100, 257, size=1024)[:, None]).astype(np.float32)
    rat[-3:] = 0
    rdr = rr.integers(0, U, size=(1024, 256)).astype(np.int32) * (rat > 0)
    ctpf_long = ((long_pad[0][:, :768].contiguous(), long_pad[1][:, :768].contiguous(), mask_pad),
                 (put(rdr, i32), put(rat, f32)))
    return dict(long=long_, long_pad=long_pad, ctpf_long=ctpf_long)


def ctpf_bucket(cpk, cbk, dev, j: int = 0):
    """The first 1024 documents of the CiteULike corpus's bucket ``j`` (0:
    the widest): (terms, counts, doc_mask) and (readers, ratings)."""
    import numpy as np
    import torch

    put = lambda a, dt: torch.as_tensor(np.ascontiguousarray(a), dtype=dt).to(dev)
    seg = cbk.segments[j]
    rows = slice(seg.loc_start, seg.loc_start + 1024)
    return ((put(seg.terms[:1024], torch.int32), put(seg.counts[:1024], torch.float32),
             put(seg.doc_mask[:1024], torch.float32)),
            (put(cbk.readers[rows], torch.int32), put(cbk.ratings[rows], torch.float32)))


def kernel_checks(dev) -> dict:
    """Phases 2 and 3 up to the small models: the corpora, then every
    kernel against its plain version at its main path's shapes (and the
    E-steps beyond shared memory), with their times and bounds."""
    import numpy as np
    import torch

    import topicmodelsvb_jl_torch as tt
    from topicmodelsvb_jl_torch.kernels import _build

    # 2. corpora
    t0 = time.perf_counter()
    packed = tt.synth_packed_nsf_scale(seed=7)
    bucketed = tt.bucketize_packed(packed, chunk=1024, pad_multiple=8)
    K, V = 100, packed.V
    print(f"corpus NSF: M={packed.M} V={V} segments={len(bucketed.segments)} "
          f"widths={[s.L for s in bucketed.segments]} ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    cpk, cbk, synth_s = citeulike()
    print(f"corpus CiteULike: M={cpk.M} V={cpk.V} U={cpk.U} Rmax={cpk.Rmax} "
          f"segments={len(cbk.segments)} widths={[s.L for s in cbk.segments]}; "
          f"synth_corpus host time {synth_s:.2f} s, packing "
          f"{time.perf_counter() - t0 - synth_s:.2f} s")

    # 3. kernel vs plain, then small models on the card against the CPU
    put = lambda a, dt: torch.as_tensor(np.ascontiguousarray(a), dtype=dt).to(dev)
    f32, i32 = torch.float32, torch.int32
    s0 = bucketed.segments[0]
    wide = (put(s0.terms[:1024], i32), put(s0.counts[:1024], f32),
            put(s0.doc_mask[:1024], f32))
    lc = long_chunks(V, cpk.U, dev)
    long_, long_pad = lc["long"], lc["long_pad"]
    i64 = ctypes.c_int64
    fit = {name: _build.function(f"tmvb_{name}_rows_in_smem", [i64] * n)
           for name, n in (("lda_estep", 2), ("flda_estep", 2), ("ctpf_estep", 3))}
    rules = {"lda_estep": [(s0.L, K, 1), (1024, K, 0)],
             "flda_estep": [(s0.L, K, 1), (1024, K, 0)],
             "ctpf_estep": [(cbk.segments[0].L, cpk.Rmax, K, 1), (768, 256, K, 0)]}
    for name, cases in rules.items():
        for *shape, want_fit in cases:
            need(fit[name](*shape) == want_fit,
                 f"{name} shared-memory rule at {shape}: {fit[name](*shape)}")
    res_wide = compare_kernels(wide, V, K, dev, f"widest bucket L={s0.L}")
    res_long = compare_kernels(long_, V, K, dev, "L=1024 rows in device memory")
    fl_wide, fl_w = compare_flda(wide, V, K, dev, f"widest bucket L={s0.L}")
    fl_long, _ = compare_flda(long_pad, V, K, dev, "L=1024 rows in device memory")
    c0 = cbk.segments[0]
    c_tok, c_rd = ctpf_bucket(cpk, cbk, dev)
    ct_wide, ct_wa, ct_wh = compare_ctpf(c_tok, c_rd, cpk.V, cpk.U, K, dev,
                                         f"CiteULike widest bucket L={c0.L} R={cpk.Rmax}")
    ct_long, _, _ = compare_ctpf(*lc["ctpf_long"], V, cpk.U, K, dev,
                                 "L=768 R=256 rows in device memory")
    # the M-step scatter on the real rows of those chunks
    one_id = torch.rand((1024 * 128, K), device=dev)
    scatter_cases = [
        (V, res_wide["w"].reshape(-1, K), wide[0], wide[1] > 0, dev,
         f"LDA w, widest NSF bucket L={s0.L}"),
        (V, fl_w.reshape(-1, K + 1), wide[0], wide[1] > 0, dev,
         f"fLDA w, widest NSF bucket L={s0.L}"),
        (cpk.V, ct_wa.reshape(-1, K), c_tok[0], c_tok[1] > 0, dev,
         f"CTPF term rows, CiteULike widest bucket L={c0.L}"),
        (max(cpk.U, 1), ct_wh.reshape(-1, K), c_rd[0], c_rd[1] > 0, dev,
         f"CTPF reader rows, CiteULike widest bucket R={cpk.Rmax}"),
        (V, one_id, torch.full((1024 * 128,), 5, dtype=i32, device=dev),
         torch.ones(1024 * 128, dtype=torch.bool, device=dev), dev, "every row one id"),
        (V, torch.zeros((wide[0].numel(), K), device=dev), wide[0], wide[1] < 0, dev,
         "empty chunk")]
    sc = [compare_scatter(*case) for case in scatter_cases]
    return dict(packed=packed, cpk=cpk, K=K, V=V, estep=(res_wide["estep"], res_long["estep"]),
                elbo=(res_wide["elbo"], res_long["elbo"]), flda=(fl_wide, fl_long),
                ctpf=(ct_wide, ct_long), scatter=sc, scatter_cases=scatter_cases)



def corpus_path(smi) -> dict:
    """Phase 6, the Corpus path: returns each kernel's launches."""
    import dataclasses

    import numpy as np
    import torch

    import topicmodelsvb_jl_torch as tt
    from topicmodelsvb_jl_torch.kernels.ctpf_estep import ctpf_estep
    from topicmodelsvb_jl_torch.kernels.flda_estep import flda_estep
    from topicmodelsvb_jl_torch.kernels.lda_elbo import lda_elbo_tok
    from topicmodelsvb_jl_torch.kernels.lda_estep import lda_estep
    from topicmodelsvb_jl_torch.kernels.scatter_rows import scatter_rows
    from topicmodelsvb_jl_torch.validate import check_model

    kernels = (lda_estep, lda_elbo_tok, flda_estep, ctpf_estep, scatter_rows)
    launches = {k.__name__: 0 for k in kernels}
    K = 100
    t_phase = time.perf_counter()

    def add(counts):
        for name, n in counts.items():
            launches[name] += n

    def step(label, fn):
        """``fn()`` with every launch count 0 before; prints its time and
        launches; returns (result, launches)."""
        for k in kernels:
            k.launches = 0
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        counts = {k.__name__: k.launches for k in kernels if k.launches}
        add(counts)
        print(f"corpus path {label}: {time.perf_counter() - t0:.3f} s, launches {counts}")
        return out, counts

    def shown(fn) -> list:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            fn()
        return buf.getvalue().splitlines()

    def held_out(corp, n):
        """The last ``n`` documents, keeping the terms some earlier
        document holds (a term no training document holds has beta = 0
        and scores log 1e-300), and the documents before them."""
        seen = {t for d in corp.docs[:-n] for t in d.terms}
        test = [tt.Document(terms=[t for t in d.terms if t in seen],
                            counts=[c for t, c in zip(d.terms, d.counts) if t in seen])
                for d in corp.docs[-n:]]
        return (tt.Corpus(docs=corp.docs[:-n], vocab=corp.vocab),
                tt.Corpus(docs=test, vocab=corp.vocab))

    def sums_to_one(pred, label):
        td = pred.topicdist(np.arange(1, pred.M + 1))
        need(td.shape == (pred.M, pred.K) and np.all(np.isfinite(td))
             and np.allclose(td.sum(-1), 1.0, atol=1e-5), f"{label}: topicdist rows")

    # NSF: load, write, read back, clean
    nsf, _ = step("load_nsf(subset=32_768)", lambda: tt.load_nsf(subset=32_768))
    os.makedirs(os.path.join(ROOT, "_tmp"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "_tmp")) as tmp:
        files = dict(docfile=os.path.join(tmp, "nsfdocs.txt"),
                     vocabfile=os.path.join(tmp, "nsfvocab.txt"))
        step("writecorp(counts=True)", lambda: tt.writecorp(nsf, counts=True, **files))
        back, _ = step("readcorp(counts=True)", lambda: tt.readcorp(counts=True, **files))
    need(back.docs == nsf.docs and back.vocab == nsf.vocab,
         "readcorp: not the corpus writecorp wrote")
    print(f"corpus path readcorp parse route: {tt.readcorp.route}")
    step("fixcorp(trim=True)", lambda: tt.fixcorp(back, trim=True))
    train, test = held_out(back, 1024)
    print(f"corpus path NSF: M={len(back)} V={len(back.vocab)} after fixcorp; "
          f"{len(train)} training and {len(test)} held-out documents")

    # LDA with no device argument: the card
    lda, _ = step("LDA(train, 100) built", lambda: tt.LDA(train, K, seed=7))
    need(lda.device.type == "cuda" and lda.state.beta.is_cuda, "LDA without device= not on CUDA")
    per_chunk = lambda m, n: (n, 0)
    add(main_path(lda, "LDA NSF Corpus", {lda_estep: per_chunk, lda_elbo_tok: lambda m, n: (0, n),
                                          scatter_rows: lambda m, n: (scatters_of(m), 0)}, smi))
    check_model(lda)
    lines, _ = step("showtopics(V=8, cols=4)", lambda: shown(lambda: lda.showtopics(V=8, cols=4)))
    for line in lines[:8]:
        print(f"  {line}")

    pred, counts = step("predict(test, lda)", lambda: tt.predict(test, lda))
    need(counts.get("lda_estep") == n_chunks_of(pred) and
         counts.get("scatter_rows") == scatters_of(pred), f"predict launches {counts}")
    sums_to_one(pred, "predict")
    for f in ("alpha", "beta"):
        need(torch.equal(getattr(pred.state, f), getattr(lda.state, f)), f"predict moved {f}")
    cpu = tt.LDA(test, K, tt.RuntimeConfig(dtype="float64"), device="cpu", seed=7)
    cpu.state = dataclasses.replace(cpu.state, alpha=lda.state.alpha.double().cpu(),
                                    beta=lda.state.beta.double().cpu())
    pc, _ = step("predict(test, lda on the CPU in f64)", lambda: tt.predict(test, cpu))
    a, b = pred.gamma.astype(np.float64), pc.gamma
    need(np.all(np.abs(a - b) <= ATOL + RTOL * np.abs(b)), "predict: card against CPU gamma "
         f"off by {np.abs(a - b).max()}")
    print(f"corpus path predict card f32 vs CPU f64: gamma max abs err {np.abs(a - b).max():.3e},"
          f" max rel err {np.max(np.abs(a - b) / np.abs(b)):.3e} (rtol {RTOL}, atol {ATOL})")
    small = tt.Corpus(docs=test.docs[:50], vocab=test.vocab)
    p50, counts = step("predict(50 documents, lda)", lambda: tt.predict(small, lda))
    need(p50.chunk_docs == 56 and counts.get("lda_estep") == n_chunks_of(p50),
         f"predict on 50 documents: chunk {p50.chunk_docs}, launches {counts}")
    sums_to_one(p50, "predict on 50 documents")
    need(np.all(np.abs(p50.gamma - b[:50]) <= ATOL + RTOL * np.abs(b[:50])),
         "predict on 50 documents: not the CPU's gamma")

    ppl, _ = step("perplexity(test, lda)", lambda: tt.perplexity(test, lda))
    need(math.isfinite(ppl) and 1.0 < ppl < lda.V, f"perplexity {ppl}")
    coh, _ = step("topic_coherence(lda, N=8)", lambda: tt.topic_coherence(lda, N=8))
    need(coh.shape == (K,) and np.all(np.isfinite(coh)), "topic_coherence")
    print(f"corpus path perplexity {ppl:.2f} (V = {lda.V}); topic coherence mean "
          f"{coh.mean():.3f}, range {coh.min():.3f} .. {coh.max():.3f}")
    gen, _ = step("gencorp(lda, M=1000, laplace_smooth=1e-6, seed=1)",
                  lambda: tt.gencorp(lda, M=1000, laplace_smooth=1e-6, seed=1))
    need(len(gen) == 1000 and gen.vocab == lda.corp.vocab, "gencorp")
    g, counts = step("LDA(gencorp) one step", lambda: tt.LDA(gen, K, seed=7).train(
        iter=1, checkelbo=1, printelbo=False))
    need(counts.get("lda_estep") == n_chunks_of(g) and math.isfinite(g.elbo),
         f"one step on the drawn corpus: launches {counts}, elbo {g.elbo}")
    flda, _ = step("fLDA(train, 100) train(iter=2)", lambda: tt.fLDA(train, K, seed=7).train(
        iter=2, checkelbo=1, printelbo=False))
    need(flda.trainer.trace[-1].delta_elbo > 0, "fLDA: ∆elbo not positive")
    fpred, counts = step("predict(test, flda)", lambda: tt.predict(test, flda))
    need(counts.get("flda_estep") == n_chunks_of(fpred), f"predict on fLDA: launches {counts}")
    sums_to_one(fpred, "predict on fLDA")

    # CiteULike: held-out readers, LDA, CTPF warm-started from it
    citeu, _ = step("load_citeu()", tt.load_citeu)
    need(citeu.shape == (16_980, 8_000, 5_551), f"CiteULike shape {citeu.shape}")
    step("fixcorp(trim=True)", lambda: tt.fixcorp(citeu, trim=True))
    (cc, held), _ = step("holdout_readers(seed=7)", lambda: tt.holdout_readers(citeu, seed=7))
    print(f"corpus path CiteULike: (M, V, U) = {cc.shape} after fixcorp, "
          f"{len(held)} held-out readers")
    lda_c, _ = step("LDA(citeu, 100) train(iter=4)", lambda: tt.LDA(cc, K, seed=7).train(
        iter=4, checkelbo=1, printelbo=False))
    ctpf, _ = step("CTPF(citeu, 100).warm_start_from(lda)",
                   lambda: tt.CTPF(cc, K, seed=7).warm_start_from(lda_c))
    need(torch.allclose(ctpf.state.alef, torch.exp(lda_c.state.beta), rtol=1e-6, atol=0.0),
         "warm_start_from: alef is not exp(beta)")
    add(main_path(ctpf, "CTPF CiteULike Corpus, warm-started",
                  {ctpf_estep: per_chunk,
                   scatter_rows: lambda m, n: (scatters_of(m, True), 0)}, smi, monotone_from=1))
    for label, fn in (("showurecs(users=1, M=5)", lambda: ctpf.showurecs(users=1, M=5)),
                      ("showdrecs(docs=1, U=5)", lambda: ctpf.showdrecs(docs=1, U=5))):
        lines, _ = step(label, lambda: shown(fn))
        need(len(lines) >= 6, f"{label}: {lines}")
        for line in lines:
            print(f"  {line}")
    recs, _ = step("ranked_users(ctpf, held)", lambda: tt.ranked_users(ctpf, held))
    ranks = tt.heldout_reader_rank(ctpf, held, recs=recs)
    r20 = tt.recall_at_k(ctpf, held, 20, recs=recs)
    med = float(np.median(ranks))
    need(0.0 <= med <= 1.0 and 0.0 <= r20 <= 1.0 and np.all(np.isfinite(ranks)),
         f"held-out readers: median rank {med}, recall@20 {r20}")
    print(f"corpus path CTPF held-out readers: median normalized rank {med:.4f}, "
          f"recall@20 {r20:.4f} ({len(held)} readers)")
    print(f"corpus path: phase wall {time.perf_counter() - t_phase:.1f} s; launches {launches}; "
          f"card {smi}")
    return launches


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import topicmodelsvb_jl_torch as tt
    from topicmodelsvb_jl_torch import convert
    from topicmodelsvb_jl_torch.kernels import _build
    from topicmodelsvb_jl_torch.kernels.ctpf_estep import ctpf_estep
    from topicmodelsvb_jl_torch.kernels.flda_estep import flda_estep
    from topicmodelsvb_jl_torch.kernels.lda_elbo import lda_elbo_tok
    from topicmodelsvb_jl_torch.kernels.lda_estep import lda_estep
    from topicmodelsvb_jl_torch.kernels.scatter_rows import scatter_rows

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. card and build
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip()
    print(smi)
    t0 = time.perf_counter()
    lib = _build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s -> {lib.name}")
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "Used" in line or "spill" in line or "entry function" in line:
            print("ptxas:", line.strip())

    # 2-3. corpora, kernels against their plain versions
    kc = kernel_checks(dev)
    packed, cpk, K, V, sc = kc["packed"], kc["cpk"], kc["K"], kc["V"], kc["scatter"]

    # 3. small models on the card against the CPU
    small = tt.synth_packed_nsf_scale(M=2000, V=500, mean_terms=30, seed=5)
    card_vs_cpu("LDA", lambda rt, d: tt.LDA(small, 10, rt, device=d, seed=1),
                convert.lda_state_to_numpy, convert.lda_state_from_numpy,
                ("alpha", "beta"), dev)
    card_vs_cpu("fLDA", lambda rt, d: tt.fLDA(small, 10, rt, device=d, seed=1),
                convert.flda_state_to_numpy, convert.flda_state_from_numpy,
                ("alpha", "beta", "kappa", "eta"), dev)
    small_c = tt.pack_corpus(tt.synth_corpus(M=1500, V=600, K=8, U=300, seed=3,
                                             mean_tokens=40, mean_terms=25,
                                             mean_readers=4), with_readers=True)
    card_vs_cpu("CTPF", lambda rt, d: tt.CTPF(small_c, 10, rt, device=d, seed=1),
                convert.ctpf_state_to_numpy, convert.ctpf_state_from_numpy,
                ("alef", "bet", "dalet", "he", "vav", "het"), dev)
    card_vs_cpu("CTM", lambda rt, d: tt.CTM(small, 10, rt, device=d, seed=1),
                convert.ctm_state_to_numpy, convert.ctm_state_from_numpy,
                ("mu", "sigma", "beta"), dev)
    card_vs_cpu("fCTM", lambda rt, d: tt.fCTM(small, 10, rt, device=d, seed=1),
                convert.fctm_state_to_numpy, convert.fctm_state_from_numpy,
                ("mu", "sigma", "beta", "kappa"), dev)

    # 4. main paths; launches per (step, ELBO pass) of each kernel
    per_chunk = lambda m, n: (n, 0)
    per_elbo = lambda m, n: (0, n)
    scatter = lambda m, n: (scatters_of(m), 0)
    launches = {}

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    rt = tt.RuntimeConfig(chunk_docs=1024, dtype="float32")
    lda = tt.LDA(packed, K, runtime=rt, device="cuda", seed=7)
    add(main_path(lda, "LDA NSF", {lda_estep: per_chunk, lda_elbo_tok: per_elbo,
                                   scatter_rows: scatter}, smi))
    flda = tt.fLDA(packed, K, runtime=rt, device="cuda", seed=7)
    add(main_path(flda, "fLDA NSF", {flda_estep: per_chunk, scatter_rows: scatter}, smi,
                  monotone_from=1))
    need(lda.gamma.shape == (packed.M, K) and np.isfinite(lda.gamma).all(),
         "LDA gamma shape/finite")
    need(flda.gamma.shape == (packed.M, K) and np.isfinite(flda.gamma).all(),
         "fLDA gamma shape/finite")
    ctpf = tt.CTPF(cpk, K, runtime=rt, device="cuda", seed=7)
    add(main_path(ctpf, "CTPF CiteULike", {ctpf_estep: per_chunk,
                                           scatter_rows: lambda m, n: (scatters_of(m, True), 0)},
                  smi, monotone_from=1))
    need(scatters_of(ctpf, True) > n_chunks_of(ctpf), "CTPF: one scatter per chunk, not two")
    own = [u + 1 for u in cpk.readers[0, : cpk.R[0]]]
    need(sorted(ctpf.drecs[0] + own) == list(range(1, ctpf.U + 1)),
         "CTPF drecs[0] is not a permutation of the users outside doc 1's readers")
    need(sorted(ctpf.urecs[0] + ctpf.libs[0]) == list(range(1, ctpf.M + 1)),
         "CTPF urecs[0] is not a permutation of the docs outside user 1's library")
    print(f"CTPF recs: drecs[0][:5]={ctpf.drecs[0][:5]} urecs[0][:5]={ctpf.urecs[0][:5]}; "
          f"scores {ctpf.scores.shape}")
    # CTM and fCTM at the JAX package's bench_ctm.py/bench_filtered.py
    # settings: K = 50 and the 2048-document chunks a model takes when no
    # RuntimeConfig is given
    Kc = 50
    ctm = tt.CTM(packed, Kc, device="cuda", seed=7)
    need(ctm.chunk_docs == 2048, f"CTM chunk {ctm.chunk_docs}")
    add(main_path(ctm, "CTM NSF", {lda_elbo_tok: per_elbo, scatter_rows: scatter}, smi,
                  monotone_from=1, pure_steps=1))
    sc_ctm, elbo_ctm = compare_ctm_chunk(ctm, dev, "CTM NSF")
    fctm = tt.fCTM(packed, Kc, device="cuda", seed=7)
    add(main_path(fctm, "fCTM NSF", {scatter_rows: scatter}, smi, monotone_from=1,
                  pure_steps=1))
    sc_fctm, _ = compare_ctm_chunk(fctm, dev, "fCTM NSF")
    sc += [sc_ctm, sc_fctm]
    for m in (ctm, fctm):
        need(m.lam.shape == (packed.M, Kc) and np.isfinite(m.lam).all(), "lambda shape/finite")
        td = m.topicdist([1, packed.M])
        need(td.shape == (2, Kc) and np.allclose(td.sum(-1), 1.0, atol=1e-5), "topicdist")
        need(np.all(np.linalg.eigvalsh(m.sigma.astype(np.float64)) > 0), "sigma not SPD")

    # 5. determinism
    same_seed_steps(lambda: tt.LDA(lda.packed, K, runtime=rt, device="cuda", seed=7),
                    ("beta", "alpha", "gamma"), "LDA")
    same_seed_steps(lambda: tt.fLDA(flda.packed, K, runtime=rt, device="cuda", seed=7),
                    ("beta", "alpha", "kappa", "eta", "gamma", "Elogtheta", "tau"), "fLDA")
    same_seed_steps(lambda: tt.CTPF(ctpf.packed, K, runtime=rt, device="cuda", seed=7),
                    ("alef", "bet", "dalet", "he", "vav", "het", "gimel", "zayin"), "CTPF")
    ctm_fields = ("mu", "sigma", "beta", "lam", "vsq", "logzeta")
    same_seed_steps(lambda: tt.CTM(ctm.packed, Kc, device="cuda", seed=7), ctm_fields, "CTM")
    same_seed_steps(lambda: tt.fCTM(fctm.packed, Kc, device="cuda", seed=7),
                    ctm_fields + ("kappa", "tau"), "fCTM")

    # 6. the Corpus path
    add(corpus_path(smi))

    # 7. results: each kernel at its main path's widest chunk, with the
    # largest error over every shape it was held at
    slower = [f"{r['label']} ({r['ms']:.4f} vs {r['library_ms']:.4f} ms device, "
              f"{r['call_ms']:.4f} vs {r['library_call_ms']:.4f} ms a call)"
              for r in sc if r["ms"] > r["library_ms"] or r["call_ms"] > r["library_call_ms"]]
    print(f"scatter_rows against index_add_ on {len(sc)} shapes: slower on "
          f"{len(slower)}{': ' + '; '.join(slower) if slower else ''}")
    rows = []
    tpu = "topicmodelsvb_jl_tpu/kernels/"
    for name, src, where, main_rec, others in (
            ("lda_estep", "lda_estep.cu", tpu + "lda_estep.py:157", *kc["estep"][:1],
             kc["estep"][1:]),
            ("lda_elbo_tok", "lda_elbo.cu", tpu + "lda_elbo.py:119", kc["elbo"][0],
             (kc["elbo"][1], elbo_ctm)),
            ("flda_estep", "flda_estep.cu", tpu + "flda_estep.py:112", kc["flda"][0],
             kc["flda"][1:]),
            ("ctpf_estep", "ctpf_estep.cu", tpu + "ctpf_estep.py:105", kc["ctpf"][0],
             kc["ctpf"][1:]),
            ("scatter_rows", "scatter_rows.cu", "bench_scatter_pallas.py:40", sc[0], sc[1:])):
        rows.append({"name": name, "route": "cuda",
                     "source": f"topicmodelsvb_jl_torch/kernels/csrc/{src}",
                     "replaces": where, "launches": launches[name],
                     "max_abs_err": max(r["max_abs_err"] for r in (main_rec, *others)),
                     **{k: main_rec[k] for k in ("ms", "call_ms", "plain_ms", "bound_ms",
                                                 "bound_by", "library_ms")}})
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
