"""Drive the PyTorch port's LDA, fLDA, CTPF, CTM, fCTM, DTM, HMTM, streaming, multi-process, tensor-parallel, sequence-parallel, CLI, float64 and wide-K paths once on one CUDA GPU.

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
7. checkpoint and resume, with the launch counts set to 0 before and read
   after: ``save_checkpoint``/``load_checkpoint`` of phase 4's LDA and CTPF
   models (time and file size, with and without ``compress="f16"``); LDA
   ``train(iter=3, checkelbo=1)`` with and without ``checkpoint_every=1``,
   in turns (wall and step times, the async writer's cost); the resume of
   2 iterations from the checkpoint of iteration 2, bitwise equal to
   phase 4's straight 4-iteration run, for LDA and for CTPF (which
   launches ``ctpf_estep`` after the load);
8. DTM at mac scale (75,011 stamped documents from seeded numpy arrays, V
   = 15,113, 12 slices, ~220 terms a document), ``DTM(corp, 20,
   delta=1.0)`` with no ``device=``, ``train(iter=3, checkelbo=1, viter=10,
   cgiter=10)`` with the counts set to 0 before: ∆elbo > 0, ``check_model``,
   two scatters a chunk a step, the step, E-step, CG and ELBO-pass times,
   the host reads of a step, ``showtopics(slices=1)``, the step bitwise
   repeatable, the scatter on the first chunk's rows against its plain
   version; then a small DTM on the card (f32) against the CPU (f64) from
   one init, two same-seed one-step DTMs bitwise equal, and a DTM
   checkpoint saved, loaded and resumed on the card;
9. HMTM: ``hmtm_estep`` and ``hmtm_logz`` against their plain versions
   on four chunks (the widest NSF bucket with unit counts at K = 25 and
   K = 100, 128 documents of L = 4,096 whose messages go to device
   memory, and a chunk with an empty, a one-token, a padded-first and
   doc_mask 0 documents), each twice, bitwise equal, with its times and
   bound, the scatter on the first chunk's r rows; the NSF corpus with
   ``unit_counts``, ``HMTM(packed, 25)`` with no ``device=``,
   ``train(iter=3, checkelbo=1, viter=10)`` with the counts set to 0
   before: ∆elbo > 0 from the second iteration, ``check_model``, one
   ``hmtm_estep`` and one scatter a chunk a step and one ``hmtm_logz`` a
   chunk a bound, the step, E-step, Newton and ELBO-pass times, the host
   reads of a step, peak memory, a step repeated bitwise and two same-seed
   one-step models bitwise equal; a small HMTM on the card against the
   CPU in f64 per element; the user path: ``load_nsf(subset=4096)`` (its
   condensed corpus refused), ``expand_corp``, ``HMTM(train, 25)``,
   ``train(iter=2)``, ``showtopics``, ``transdist(1)``, ``predict`` on 256
   held-out documents against the CPU's f64 ``predict``, ``perplexity``,
   ``gencorp(M=100)`` and one step on it, and a checkpoint saved, loaded
   and resumed on the card, bitwise equal to the straight run;
10. host-streamed training, with the counts set to 0 before each main
   run and read after: the dense NSF corpus (128,804 documents padded to
   131,072, L = 128), ``lda_estep``/``lda_elbo_tok`` and the scatter
   against their plain versions on its first 1024-document chunk;
   ``StreamingLDA(packed, 100)`` with no ``device=`` (batch_docs 8192,
   chunk 1024: 16 batches of 8 chunks), ``train(iter=3, checkelbo=1)``:
   ∆elbo > 0, its launches, each sweep's wall, bytes copied each way, the
   copies' device ms and the host's seconds blocked on them, the plans'
   build seconds and bytes, the peak device memory under a printed
   O(batch) bound; against the in-memory ``LDA`` from the same init
   (beta by the norm, alpha, the bound); bitwise equal: ``batch_docs``
   16384, a same-seed rerun, a ``save`` at iteration 2 then ``load`` and
   one iteration, a ``state_dir`` run on a ``load_packed`` memory map;
   ``train_online(epochs=1)`` raising the bound; ``to_model()``'s
   ``topicdist`` against the streamed gamma; then StreamingFLDA (NSF V,
   16,384 documents, K = 100), StreamingCTPF (the CiteULike corpus in
   full, K = 100), StreamingCTM and StreamingFCTM (NSF V, 8,192 documents,
   K = 50), StreamingHMTM (NSF unit counts, 16,384 documents, K = 25) and
   StreamingDTM (mac V, T = 12, 8,192 documents, K = 20): 3 iterations,
   ∆elbo > 0 (from the second for all but DTM), their kernels' launches,
   two same-seed runs bitwise equal, sweep walls; each family small on the
   card against the CPU in f64 from one init;
12. (run before 11's results) the data axis across processes, the
   counts set to 0 before each run in each process and read after: two
   processes of a gloo group sharing the card (``chip_smoke.py --p12``,
   ``parallel_child``) build ``LDA(packed, 100)`` with no ``device=`` and
   no ``mesh=`` on the dense NSF corpus (phase 10's), ``train(iter=3,
   checkelbo=1)``: ∆elbo > 0, each rank's launches (every chunk of its
   slab), one step alone with its collectives' time; a checkpoint
   directory and one iteration more; StreamingLDA, 2 iterations, a save,
   1 more; fLDA, CTPF, CTM, fCTM, HMTM and DTM at phase 10's depths,
   ``train(iter=2, checkelbo=1)``; here: every global and bound bitwise
   equal across the ranks, LDA and StreamingLDA against one process from
   the same init (rtol 5e-3 / atol 1e-5 on beta and alpha, 1e-5 on the
   bound per iteration), the checkpoint directory loaded and resumed in one
   process against the two ranks' resume, the streaming checkpoint loaded
   in one process; then one process of an NCCL group: LDA on its mesh
   bitwise equal to LDA with no collective;
13. (run before 11's results; its two ranks also run phase 15's and
   phase 17's cases) tensor and sequence parallelism, the counts
   set to 0 before each run in each process and read after: here, the
   E-step's pass mode (``lda_estep_pass``) against its plain version on a
   routed chunk (the first 1024 documents' slots of vocab block 0 of 2)
   and a sequence-axis chunk (their first half of the token axis), K =
   100, bitwise repeatable, its times and bound; then two processes of a
   gloo group sharing the card (``chip_smoke.py --p13``, ``tp_child``)
   run ``make_step``/``make_elbo`` from each family's init (seed 7, cut
   by ``convert.shard_state``): LDA on the dense NSF corpus with V =
   25,320 (NSF's 25,319 does not split into two vocab blocks) at K = 100
   with beta's storage over the vocab axis (3 iterations), routed
   (``route_packed(n_shards=2)``, 2 iterations) and on the sequence axis
   (2 iterations), each with one step alone and its collectives' time,
   calls and bytes; the vocab axis for fLDA, CTM, fCTM, HMTM (NSF V + 1),
   DTM (mac V + 1) at phase 10's depths and CTPF on CiteULike (one empty
   user more, U = 5,552, for the user axis) on the vocab and on the user
   axis, 2 iterations; StreamingLDA with the vocab axis, 2 iterations;
   and phase 15's runs (below): ∆elbo > 0, every kernel of each path
   launched; here: every global and bound bitwise equal across the ranks,
   and LDA's three modes against one process from the same init (rtol
   5e-3 / atol 1e-5 on beta and alpha, 1e-5 on the bound per iteration);
14. (run before 11's results) the CLI and the f64 Elogtheta channel: the
   f64-channel modes of ``lda_estep`` and ``flda_estep`` against their
   plain versions (ψ in float64) on phase 3's widest NSF chunk and its
   L = 1024 chunk, bitwise repeatable, El not the f32 mode's, their times
   and bounds; then ``train.run`` (what ``python -m
   topicmodelsvb_jl_torch.train`` calls), the counts set to 0 before each
   run and read after: ``--model lda --corpus nsf-scale --k 100 --iter 5
   --checkelbo 1`` with ``--metrics`` and ``--save`` (∆elbo > 0, the rows
   number the iterations, ``flops_per_step`` from the bucketed corpus, an
   ``mfu`` in (0, 1] against the card's own peak, which is printed, every
   chunk's launches); 2 iterations on 16,384 documents with
   ``--profile-dir`` (the trace's ``cavi_step`` of iteration 2 and its
   E-step kernels); the checkpoint
   loaded and resumed one iteration; the same LDA with ``--elogtheta-f64`` (only the f64 mode
   launched) and fLDA with it (4 iterations); ``--model ctpf --corpus
   citeu --iter 3``; ``--streaming`` LDA on the NSF corpus (2 iterations);
   and ``python -m topicmodelsvb_jl_torch.train`` as one rank of an NCCL
   group (``--coordinator``, 16,384 documents, 2 iterations);
15. (run before 11's results) the sequence axis of fLDA, CTM, fCTM and
   CTPF: here, the pass modes of the fLDA and CTPF E-steps
   (``flda_estep_pass``, ``ctpf_estep_pass``) against their plain
   versions on rank 0's half of the token (and reader) slots of the first
   1024 documents of phase 13's NSF corpus cut to 16,384 documents and of
   the dense CiteULike corpus, K = 100, and on half of phase 3's chunks
   whose rows do not fit shared memory: within RTOL/ATOL, bitwise
   repeatable, zeros on masked documents, their times and bounds; both
   E-steps at ``viter = 0`` (the split fixpoints' last call: the state as
   given, the rows against the plain versions); phase 13's two ranks
   (``tp_child``, so the corpora load once) on a (data, seq) = (1, 2)
   mesh run fLDA (NSF V = 25,320, K = 100, 16,384 documents), CTM and
   fCTM (8,192 documents, K = 50, chunks of 2,048) and CTPF (CiteULike,
   all 16,980 documents, one empty user more, K = 100) from each init
   (seed 7, cut by ``convert.shard_state``), 2 iterations each and one
   step alone with its collectives' time, calls and bytes: ∆elbo > 0, the
   pass kernels, the ``viter = 0`` launches, the scatter and CTM's
   ``lda_elbo_tok`` launched, the ranks bitwise equal; here, each family
   against one process with no mesh on the same corpus from the same
   init (rtol 5e-3 / atol 1e-5 on every global, 1e-5 on the bound per
   iteration);
16. (run before 11's results) float64 on the card (``double_phase``):
   the float64 modes of ``lda_estep``, ``flda_estep``, ``lda_elbo_tok``
   and ``scatter_rows`` against their plain float64 versions on phase 3's
   widest NSF chunk cast to float64 (rtol 1e-9, atol 1e-12), bitwise
   repeatable, zeros on masked documents, with device and call times and
   bounds (8-byte elements, operations at the card's f64 rate: SMs x 64
   x 2 x the max SM clock); LDA and fLDA (K = 100) and CTM and fCTM (K =
   50, chunks of 2048) on phase 13's NSF corpus cut to 2,048 documents,
   and phase 8's small DTM (cgtol = 0), each on the card and on the CPU in
   float64 from one init, 2 iterations (the CPU's references set the
   depth), within 1e-8 per iteration on the
   globals and the bound, the float64 modes' launches counted there; DTM
   at the mac shape in float64 and float32 on the card, 3 iterations from
   one init, and the float32 run's departure from the float64 one; the
   scatter's float64 mode on the mac DTM's first chunk; StreamingLDA and
   StreamingDTM in float64, 2 sweeps; ``python -m
   topicmodelsvb_jl_torch.train --dtype float64`` for LDA (2 iterations,
   its MFU against the f64 peak); a float64 LDA checkpoint written on the
   CPU resumed on the card, bitwise equal to a straight card run; and the
   dtype gate refusing float16 CTPF, HMTM, StreamingHMTM and seq LDA on the
   card before any launch or allocation;
17. (run before 11's results) every dtype and K on the card
   (``dtype_phase``): the float64 modes of ``ctpf_estep``, its pass mode,
   ``lda_estep_pass``, ``flda_estep_pass``, ``hmtm_estep`` and
   ``hmtm_logz`` against their plain float64 versions on the widest chunk
   of each main path cast to float64 (CiteULike's widest bucket; rank 0's
   half of the first 1024 NSF or CiteULike documents' slots; phase 9's
   widest NSF chunk), within rtol 1e-9 / atol 1e-12, bitwise repeatable,
   masked documents untouched, with times and bounds; HMTM's wide mode in
   float32 at K = 240, 256, 257, 300 and 512 (rtol 5e-3 / atol 1e-5) and
   in float64 at K = 169 and 170 on small chunks, and at K = 300 on the
   widest NSF chunk with its times; then, the counts set to 0 before each
   run and read after: CTPF at CiteULike scale (K = 100, every document)
   in float64 on the card, its first iteration within 1e-8 of the CPU's
   float64 one from the same init; HMTM K = 25 in float64 on NSF unit
   counts cut to 2,048 documents, card against CPU, 2 iterations within
   1e-8; HMTM K = 300 in float32 on the NSF vocabulary cut to 2,048
   documents, 2 iterations through the wide mode (∆elbo > 0); phase 13's
   two ranks' float64 routed and seq LDA, seq fLDA (8,192 documents) and
   seq CTPF (CiteULike) against one float64 process within 1e-8; and
   ``train.run`` with ``--model ctpf --dtype float64`` and ``--model hmtm
   --k 300``;
11. the scatter against ``index_add_`` on every shape; one JSON line with
   every kernel's launches, largest error, device and call times, plain
   version's time, bound (``bound_ms``, ``bound_by``) and library call's
   time (``library_ms``, null where no PyTorch call computes the same
   function), each at its main path's widest chunk; the card again; and
   last ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import io
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import types

RTOL, ATOL = 5e-3, 1e-5   # the JAX package's Pallas-vs-XLA tolerance in f32
RTOL64, ATOL64 = 1e-9, 1e-12   # a float64 kernel against its plain float64 version
# phase 16's card-against-CPU runs: the NSF corpus cut to this many
# documents, this many iterations (the CPU's float64 references set the
# phase's time; the widths stay)
P16_DOCS, P16_ITERS = 2048, 2
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


def bound_ms(nbytes: float, flops: float, rate: float = F32_FLOPS) -> tuple:
    """The least time the card could take for work that moves ``nbytes``
    (each input read once, each output written once) and does ``flops``
    operations outside the tensor cores at ``rate`` (f32 by default):
    (ms, "bytes" or "operations")."""
    tb, tf = nbytes / HBM_BYTES_PER_S, flops / rate
    return max(tb, tf) * 1e3, ("bytes" if tb >= tf else "operations")


def timed(fn):
    """(result, seconds) of one call of ``fn`` on the host clock, between
    two synchronizes."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


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


def close(got, want, names, label, rtol=RTOL, atol=ATOL) -> float:
    """Every output finite and within rtol/atol (RTOL/ATOL by default) of
    the plain version; returns the largest absolute difference."""
    import torch

    err = 0.0
    for name, a, b in zip(names, got, want):
        need(bool(torch.all(torch.isfinite(a))), f"{label}: {name} not finite")
        excess = (a - b).abs() - (atol + rtol * b.abs())
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


def lda_args(seg, V, K, dev) -> tuple:
    """``lda_estep``'s arguments on one chunk (random beta, seed 11; a warm
    state, seed 12), and beta_old for the bound's tables."""
    import torch

    from topicmodelsvb_jl_torch.utils.numerics import EPSILON, dirichlet_ones

    terms, counts, doc_mask = seg
    g = torch.Generator().manual_seed(11)
    beta = dirichlet_ones(g, V, (K,)).to(dev)
    beta_old = dirichlet_ones(g, V, (K,)).to(dev)
    betaT = (beta + EPSILON).T.contiguous()
    alpha, gamma, El, El_old = warm_state(K, terms.shape[0], dev, seed=12)
    return (betaT, terms, counts, doc_mask, alpha, gamma, El, El_old), beta, beta_old


def compare_kernels(seg, V, K, dev, label):
    """Both LDA kernels against their plain versions on one chunk."""
    import torch

    from topicmodelsvb_jl_torch.kernels import lda_estep as estep_mod
    from topicmodelsvb_jl_torch.kernels.lda_elbo import lda_elbo_tok, lda_elbo_tok_ref
    from topicmodelsvb_jl_torch.kernels.lda_estep import lda_estep, lda_estep_ref
    from topicmodelsvb_jl_torch.utils.numerics import EPSILON

    terms, counts, doc_mask = seg
    B, L = terms.shape
    args, beta, beta_old = lda_args(seg, V, K, dev)
    El, El_old = args[6], args[7]
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


def flda_args(seg, V, K, dev) -> tuple:
    """``flda_estep``'s arguments on one chunk: random log beta, kappa and
    tau (seed 21), a warm state (seed 22), eta 0.6."""
    import torch

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
    return (logbetaT, kappa, terms, counts, doc_mask, alpha, eta, gamma, El, El_old,
            tau, tau_old)


def compare_flda(seg, V, K, dev, label):
    """flda_estep against its plain version on one chunk."""
    import torch

    from topicmodelsvb_jl_torch.kernels import flda_estep as flda_mod
    from topicmodelsvb_jl_torch.kernels.flda_estep import flda_estep, flda_estep_ref

    terms, counts, doc_mask = seg
    B, L = terms.shape
    args = flda_args(seg, V, K, dev)
    gamma, El, El_old, tau, tau_old = args[7:]
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
    """scatter_rows against its plain version on one chunk's rows [T, W]
    (in w's dtype: float64 rows take the float64 mode, held at
    RTOL64/ATOL64, its bound at 8-byte elements and the f64 rate); also
    times ``index_add_`` over all T rows, the one PyTorch call that
    computes the same sums (atomic on the card, so a yardstick only)."""
    import torch

    from topicmodelsvb_jl_torch import engine

    from topicmodelsvb_jl_torch.kernels.scatter_rows import (
        build_plan, scatter_rows, scatter_rows_ref,
    )

    ids, keep = ids.reshape(-1), keep.reshape(-1)
    plan = build_plan(ids.cpu().numpy(), keep.cpu().numpy()).to(dev)
    W = w.shape[1]
    f64 = w.dtype == torch.float64
    acc = torch.rand((V, W), device=dev, dtype=w.dtype)
    n0 = scatter_rows.launches
    got = scatter_rows(acc.clone(), w, plan)
    want = scatter_rows_ref(acc.clone(), w, plan)
    torch.cuda.synchronize()
    need(scatter_rows.launches == n0 + (plan.n_pieces > 0), f"scatter_rows {label}: launches")
    err = close([got], [want], ["acc"], f"scatter_rows {label}",
                *((RTOL64, ATOL64) if f64 else (RTOL, ATOL)))
    need(torch.equal(got, scatter_rows(acc.clone(), w, plan)),
         f"scatter_rows {label}: not bitwise repeatable")
    need(bool(torch.all(w[~keep] == 0)), f"scatter_rows {label}: a left-out row is not 0")
    ids_l = ids.long()
    kept, uniq = plan.rows.shape[0], n_unique(ids, keep)
    size = w.element_size()
    r = record(err, time_calls(lambda: scatter_rows(acc, w, plan), N_KERNEL),
               time_calls(lambda: scatter_rows_ref(acc, w, plan), N_KERNEL),
               bound_ms(size * (kept * W + 2 * uniq * W) + 4 * (kept + 3 * plan.n_pieces),
                        kept * W, engine.device_peak_flops(dev, w.dtype) if f64 else F32_FLOPS),
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
    model.smoke_step_s = statistics.median(pure)   # phase 10 prints it beside its sweep
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
    return dict(packed=packed, bucketed=bucketed, cpk=cpk, K=K, V=V, estep=(res_wide["estep"], res_long["estep"]),
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


def equal_states(a, b, fields, label) -> None:
    """Two states' fields bit for bit."""
    import torch

    for f in fields:
        need(torch.equal(getattr(a, f), getattr(b, f)), f"{label}: {f} differs")


def checkpoint_phase(lda, ctpf, packed, cpk, rt, smi) -> dict:
    """Phase 7, checkpoint and resume on phase 4's LDA (NSF) and CTPF
    (CiteULike) models: returns each kernel's launches."""
    import torch

    import topicmodelsvb_jl_torch as tt
    from topicmodelsvb_jl_torch.kernels.ctpf_estep import ctpf_estep
    from topicmodelsvb_jl_torch.kernels.lda_elbo import lda_elbo_tok
    from topicmodelsvb_jl_torch.kernels.lda_estep import lda_estep
    from topicmodelsvb_jl_torch.kernels.scatter_rows import scatter_rows

    kernels = (lda_estep, lda_elbo_tok, ctpf_estep, scatter_rows)
    for k in kernels:
        k.launches = 0
    t_phase = time.perf_counter()
    K = lda.K
    lda_fields = ("alpha", "beta", "beta_old", "gamma", "Elogtheta", "Elogtheta_old")
    ctpf_fields = tuple(f for f in vars(ctpf.state) if f != "elbo")
    os.makedirs(os.path.join(ROOT, "_tmp"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "_tmp")) as tmp:
        # save and load, full and f16
        for model, src, label, fields in ((lda, packed, "LDA NSF", lda_fields),
                                          (ctpf, cpk, "CTPF CiteULike", ctpf_fields)):
            t0 = time.perf_counter()
            _ = model._fingerprint   # hashed once a model
            fp_s = time.perf_counter() - t0
            for compress in (None, "f16"):
                path = os.path.join(tmp, f"{label.split()[0]}_{compress}.npz")
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                tt.save_checkpoint(path, model, compress=compress)
                save_s = time.perf_counter() - t0
                t0 = time.perf_counter()
                back = tt.load_checkpoint(path, src)
                torch.cuda.synchronize()
                load_s = time.perf_counter() - t0
                need(back.device.type == "cuda" and back.trained_iters == model.trained_iters,
                     f"{label} load: device {back.device}, iteration {back.trained_iters}")
                if compress is None:
                    equal_states(back.state, model.state, fields + ("elbo",), f"{label} load")
                else:
                    for f in fields:
                        a, b = getattr(back.state, f), getattr(model.state, f)
                        need(bool(torch.all((a - b).abs() <= 1e-3 * b.abs() + 1e-4)),
                             f"{label} f16 load: {f}")
                print(f"checkpoint {label} compress={compress}: save {save_s:.3f} s, "
                      f"{os.path.getsize(path) / 2**20:.1f} MiB; load {load_s:.3f} s "
                      f"(fingerprint {fp_s:.3f} s, once a model); card {smi}")
                del back

        # train(iter=3) with and without the auto-checkpoint, in turns
        runs = {}
        for i, every in enumerate((0, 1, 1, 0)):
            d = os.path.join(tmp, f"auto{i}")
            m = tt.LDA(packed, K, runtime=dataclasses.replace(
                rt, checkpoint_every=every, checkpoint_dir=d if every else None), seed=7)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m.train(iter=3, checkelbo=1, printelbo=False)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            steps = [x.step_time_s for x in m.trainer.trace]
            runs.setdefault(every, []).append((wall, steps, m, d))
            print(f"checkpoint LDA NSF train(iter=3, checkelbo=1) checkpoint_every={every}: "
                  f"wall {wall:.3f} s, step+ELBO times {', '.join(f'{x:.4f}' for x in steps)} s"
                  + (f", files {sorted(os.listdir(d))}" if every else ""))
        plain, ck = runs[0][0][2], runs[1][0][2]
        equal_states(ck.state, plain.state, lda_fields,
                     "LDA with checkpoint_every=1 against without")
        need(sorted(os.listdir(runs[1][0][3])) == [f"ckpt_iter{k:06d}" for k in (1, 2, 3)],
             "checkpoint_every=1: files")
        med = {e: statistics.median(r[0] for r in v) for e, v in runs.items()}
        print(f"checkpoint LDA NSF async writer: median train wall {med[1]:.3f} s with, "
              f"{med[0]:.3f} s without ({(med[1] / med[0] - 1) * 100:+.1f}%)")

        # resume from iteration 2, against phase 4's straight 4-iteration run
        r = tt.load_checkpoint(os.path.join(runs[1][0][3], "ckpt_iter000002"), packed)
        n0 = lda_estep.launches
        r.train(iter=2, checkelbo=1, printelbo=False)
        need([x.k for x in r.trainer.trace] == [3, 4], "LDA resume: iteration numbers")
        need(lda_estep.launches - n0 == 2 * n_chunks_of(r), "LDA resume: lda_estep launches")
        equal_states(r.state, lda.state, ("alpha", "beta", "gamma"),
                     "LDA resume against the straight run")
        print(f"checkpoint LDA NSF resume 2 iterations from iteration 2: alpha, beta, gamma "
              f"bitwise equal to the straight 4-iteration run; elbo {r.elbo:.3f} vs {lda.elbo:.3f}")
        c2 = tt.CTPF(cpk, K, runtime=rt, seed=7)
        c2.train(iter=2, checkelbo=1, printelbo=False)
        path = os.path.join(tmp, "ctpf2.npz")
        tt.save_checkpoint(path, c2)
        rc = tt.load_checkpoint(path, cpk)
        n0 = ctpf_estep.launches
        rc.train(iter=2, checkelbo=1, printelbo=False)
        need(ctpf_estep.launches - n0 == 2 * n_chunks_of(rc), "CTPF resume: ctpf_estep launches")
        equal_states(rc.state, ctpf.state, ctpf_fields, "CTPF resume against the straight run")
        need(rc.drecs[0] == ctpf.drecs[0], "CTPF resume: drecs[0]")
        print(f"checkpoint CTPF CiteULike resume 2 iterations from iteration 2: "
              f"{', '.join(ctpf_fields)} bitwise equal to the straight run")
    launches = {k.__name__: k.launches for k in kernels}
    for name in ("lda_estep", "lda_elbo_tok", "ctpf_estep", "scatter_rows"):
        need(launches[name] > 0, f"checkpoint phase: {name} never launched")
    print(f"checkpoint phase: wall {time.perf_counter() - t_phase:.1f} s; launches {launches}; "
          f"card {smi}")
    return launches


@functools.lru_cache(maxsize=1)   # phases 8 and 16 build it once
def mac_corpus(M=75_011, V=15_113, T=12, K=20, seed=7):
    """A stamped corpus at the mac corpus's shape (v0.6 ``readcorp(:mac)``:
    75,011 documents, V = 15,113, 12 yearly slices) from seeded numpy
    arrays: each document draws ~400 tokens, 80% from its topic's band of
    the vocabulary (shifted a little a slice, so the topics drift) and the
    rest from a skewed background, and keeps the distinct terms with their
    counts (~220 a document).  ``load_mac()``'s synthetic build draws a
    ``rng.choice`` over V for each document, as ``load_nsf``'s does."""
    import numpy as np

    import topicmodelsvb_jl_torch as tt

    r = np.random.default_rng(seed)
    stamps = r.uniform(0.0, T, M)
    sl = np.minimum(stamps.astype(np.int64), T - 1)
    z = r.integers(0, K, M)
    doc = np.repeat(np.arange(M, dtype=np.int64), 1 + r.poisson(399, M))
    band = V // K
    topical = r.random(doc.size) < 0.8
    t_top = (z[doc] * band + sl[doc] * (band // (2 * T))
             + (band * r.random(doc.size) ** 5).astype(np.int64)) % V
    t_bg = np.minimum((V * r.random(doc.size) ** 4).astype(np.int64), V - 1)
    uniq, cnt = np.unique(doc * V + np.where(topical, t_top, t_bg), return_counts=True)
    bounds = np.searchsorted(uniq // V, np.arange(M + 1)).tolist()
    terms, counts = (uniq % V + 1).tolist(), cnt.tolist()
    docs = [tt.Document(terms=terms[a:b], counts=counts[a:b], stamp=s)
            for a, b, s in zip(bounds[:-1], bounds[1:], stamps.tolist())]
    return tt.Corpus(docs=docs, vocab={j: f"term{j}" for j in range(1, V + 1)})


def dtm_chunk_scatter(dtm, dev, label) -> list:
    """The scatter on the first chunk of a DTM's state, both of its
    plans (A's rows by slice·V + term, the per-slice rows by slice id),
    against its plain version and ``index_add_``: the records."""
    import torch

    from topicmodelsvb_jl_torch.models import dtm as dtm_mod

    K, T, V, B, st = dtm.K, dtm.T, dtm.V, dtm.chunk_docs, dtm.state
    sid, terms, counts, dm = (x[:B] for x in dtm._step_data())
    maxl, rowsum, mflat = dtm_mod._overflow_safe(st)
    flat = sid[:, None] * V + terms
    g, el, lz, w, pc = dtm_mod._estep_chunk(mflat, st.alpha, rowsum, maxl, sid, flat, counts,
                                            dm, st.gamma[:B], st.Elogtheta[:B], st.lzeta[:B],
                                            10, 1.0 / K**2)
    per_doc = torch.cat([torch.exp(-lz)[:, None] * pc * dm[:, None], el * dm[:, None],
                         dm[:, None]], dim=1).contiguous()
    return [compare_scatter(T * V, w.reshape(-1, K).contiguous(), flat, counts > 0, dev,
                            f"DTM A rows, {label} first chunk L={dtm.packed.L}"),
            compare_scatter(T, per_doc, sid, dm > 0, dev,
                            f"DTM per-slice rows, {label} first chunk")]


def dtm_card_vs_cpu(corp, dev) -> None:
    """A small DTM on the card (f32, the scatter kernel) against the CPU
    (f64, plain versions) from one init, stage by stage:

    1. one E-step sweep: every statistic of the M-step, per element within
       rtol 1e-3, atol 1e-6, the other families' check (``card_vs_cpu``);
    2. the M-step (alpha Newtons, 5 CG iterations) from the CPU's f64
       statistics rounded to f32: alpha, betahat and mbeta, the same;
    3. three iterations of ``train`` (cgiter 5, cgtol 0): the ELBO within
       1e-4 and alpha per element, the same; betahat and mbeta by the norm
       of the difference, within 2e-3 of the norm.  Three iterations of f32
       rounding move a few of their entries past rtol 1e-3 on any device:
       on the CPU one ulp of the initial betahat does
       (``tools/dtm_f32_error.py``)."""
    import numpy as np
    import torch

    import topicmodelsvb_jl_torch as tt
    from topicmodelsvb_jl_torch import convert
    from topicmodelsvb_jl_torch.models import dtm as dtm_mod

    make = lambda dtype, d: tt.DTM(corp, 10, delta=1.0, seed=1, device=d,
                                   runtime=tt.RuntimeConfig(chunk_docs=256, dtype=dtype))
    gpu, cpu = make("float32", dev), make("float64", "cpu")
    cpu.state = convert.dtm_state_from_numpy(convert.dtm_state_to_numpy(gpu.state), "cpu",
                                             torch.float64)
    worst = {}

    def per_element(stage, names, got, want):
        for n, a, b in zip(names, got, want):
            a, b = a.detach().cpu().double().numpy(), b.detach().numpy()
            need(np.allclose(a, b, rtol=1e-3, atol=1e-6), f"small DTM card vs CPU, {stage}: {n}")
            worst[stage] = max(worst.get(stage, 0.0),
                               float(np.max(np.abs(a - b) / (1e-6 + np.abs(b)))))

    stats = []
    for m in (gpu, cpu):
        sweep = dtm_mod.make_sweep(m.packed, m.K, m.T, 10, 1.0 / m.K**2, m.chunk_docs,
                                   m.slice_id, m.device)
        g, el, lz, A, wz, els, nd = sweep(m.state, *m._step_data())
        stats.append((g, el, lz, A, wz, els[0], nd, els[1]))
    per_element("one sweep", ("gamma", "Elogtheta", "lzeta", "A", "wz", "els", "nd"),
                stats[0][:7], stats[1][:7])
    update = dtm_mod.make_global_update(1000, 1.0 / gpu.K**2, 5, 0.0)
    outs = []
    for m in (gpu, cpu):
        st = m.state
        A, wz, els, nd, els_lo = (x.to(st.betahat.device, st.betahat.dtype)
                                  for x in stats[1][3:])
        outs.append(update(st.alpha, st.betahat, st.v_filt, st.vbeta, A, wz, els, els_lo, nd))
    per_element("M-step", ("alpha", "betahat", "mbeta"), *outs)
    for m in (gpu, cpu):
        m.train(iter=3, checkelbo=1, printelbo=False, cgiter=5, cgtol=0.0)
    ge = [x.elbo for x in gpu.trainer.trace]
    ce = [x.elbo for x in cpu.trainer.trace]
    rel = max(abs(a - b) / abs(b) for a, b in zip(ge, ce))
    need(rel <= 1e-4, f"small DTM: f32 card ELBO {ge} vs f64 CPU {ce}")
    per_element("3 iterations", ("alpha",), (gpu.state.alpha,), (cpu.state.alpha,))
    norms = []
    for f in ("betahat", "mbeta"):
        a, b = np.asarray(getattr(gpu, f), np.float64), np.asarray(getattr(cpu, f))
        norms.append(float(np.linalg.norm(a - b) / np.linalg.norm(b)))
        need(norms[-1] <= 2e-3, f"small DTM, 3 iterations: {f} differs by {norms[-1]:.3e} "
             "of its norm")
    print(f"small DTM (M={gpu.M}, T={gpu.T}, K={gpu.K}): card f32 vs CPU f64 from one init, "
          f"worst rel diff per element: one sweep {worst['one sweep']:.3e}, the M-step from "
          f"the CPU's statistics {worst['M-step']:.3e}; 3 iterations: ELBO {rel:.3e}, alpha "
          f"{worst['3 iterations']:.3e}, betahat and mbeta {norms[0]:.3e} and {norms[1]:.3e} "
          "by the norm of the difference over the norm")


def dtm_phase(smi, dev) -> tuple:
    """Phase 8, DTM at mac scale and a small DTM: returns each kernel's
    launches and the scatter's records on DTM's first chunk."""
    import numpy as np
    import torch

    import topicmodelsvb_jl_torch as tt
    from topicmodelsvb_jl_torch.engine import HostReads
    from topicmodelsvb_jl_torch.kernels.ctpf_estep import ctpf_estep
    from topicmodelsvb_jl_torch.kernels.flda_estep import flda_estep
    from topicmodelsvb_jl_torch.kernels.lda_elbo import lda_elbo_tok
    from topicmodelsvb_jl_torch.kernels.lda_estep import lda_estep
    from topicmodelsvb_jl_torch.kernels.scatter_rows import scatter_rows
    from topicmodelsvb_jl_torch.validate import check_model

    kernels = (lda_estep, lda_elbo_tok, flda_estep, ctpf_estep, scatter_rows)
    t_phase = time.perf_counter()
    corp, build_s = timed(mac_corpus)
    dtm, model_s = timed(lambda: tt.DTM(corp, 20, delta=1.0, seed=7))
    K, T, V = dtm.K, dtm.T, dtm.V
    n_chunks = dtm.packed.M_pad // dtm.chunk_docs
    need(dtm.device.type == "cuda" and dtm.state.betahat.is_cuda, "DTM without device= not on CUDA")
    need((dtm.M, V, T, dtm.chunk_docs) == (75_011, 15_113, 12, 1024),
         f"DTM shape {(dtm.M, V, T, dtm.chunk_docs)}")
    print(f"DTM mac: M={dtm.M} V={V} T={T} K={K} mean terms a document "
          f"{np.mean(dtm.N):.1f}, tokens {np.mean(dtm.C):.1f}, L={dtm.packed.L}, "
          f"{n_chunks} chunks of {dtm.chunk_docs}; corpus built in {build_s:.2f} s, "
          f"DTM(corp, 20, delta=1.0) in {model_s:.2f} s")
    for k in kernels:
        k.launches = 0
    _, wall = timed(lambda: dtm.train(iter=3, checkelbo=1, viter=10, cgiter=10))
    launches = {k.__name__: k.launches for k in kernels}
    deltas = [x.delta_elbo for x in dtm.trainer.trace]
    need(len(deltas) == 3 and all(d > 0 for d in deltas), f"DTM: ∆elbo {deltas}")
    check_model(dtm)
    need(launches["scatter_rows"] == 3 * 2 * n_chunks and
         sum(launches.values()) == launches["scatter_rows"],
         f"DTM: launches {launches}, want 2 scatters a chunk a step ({n_chunks} chunks)")
    tr, st = dtm.trainer, dtm.state
    step = tr.step_fn
    sweep_out, estep_s = timed(lambda: step.sweep(st, *tr.data))
    _, cg_s = timed(lambda: step.update(st.alpha, st.betahat, st.v_filt, st.vbeta,
                                        *sweep_out[3:5], *sweep_out[5], sweep_out[6]))
    s1, step_s = timed(lambda: step(st, *tr.data))
    with HostReads() as reads:
        s2 = step(st, *tr.data)
    _, elbo_s = timed(lambda: tr.elbo_fn(st, *tr.elbo_data))
    equal_states(s1, s2, ("alpha", "betahat", "mbeta", "gamma", "Elogtheta", "lzeta"),
                 "DTM mac: one step from one state, twice")
    steps = [x.step_time_s for x in dtm.trainer.trace]
    print(f"DTM mac train(iter=3, checkelbo=1, viter=10, cgiter=10): {wall:.2f} s; ∆elbo "
          f"{', '.join(f'{d:.3f}' for d in deltas)}; step+ELBO {', '.join(f'{x:.3f}' for x in steps)}"
          f" s; step alone {step_s:.3f} s (E-step sweep {estep_s:.3f} s, alpha Newtons and CG "
          f"{cg_s:.3f} s), ELBO pass {elbo_s:.3f} s; host reads a step {reads.n}; "
          f"launches {launches}; peak mem {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
          f"card {smi}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        dtm.showtopics(V=8, slices=1, cols=5, topics=range(1, 6))
    for line in buf.getvalue().splitlines():
        print(f"  {line}")

    sc = dtm_chunk_scatter(dtm, dev, "mac")
    del dtm, corp, tr, st, s1, s2, sweep_out

    # a small DTM: card against CPU, determinism, a checkpoint on the card
    small = tt.synth_corpus(M=1500, V=600, K=8, seed=3, n_slices=5, drift=0.2, mean_tokens=60,
                            mean_terms=40)
    dtm_card_vs_cpu(small, dev)
    same_seed_steps(lambda: tt.DTM(small, 10, delta=1.0, seed=7),
                    ("alpha", "betahat", "mbeta", "gamma", "lzeta"), "DTM")
    g = tt.DTM(small, 10, delta=1.0, runtime=tt.RuntimeConfig(chunk_docs=256), seed=1)
    g.train(iter=2, checkelbo=1, printelbo=False, cgiter=5)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "_tmp")) as tmp:
        path = os.path.join(tmp, "dtm.npz")
        _, save_s = timed(lambda: tt.save_checkpoint(path, g))
        back, load_s = timed(lambda: tt.load_checkpoint(path, small))
        size = os.path.getsize(path)
    need(back.device.type == "cuda" and back.T == g.T and back.trained_iters == 2,
         "DTM checkpoint: model")
    fields = tuple(vars(g.state))
    equal_states(back.state, g.state, fields, "DTM checkpoint on the card")
    for m in (g, back):
        m.train(iter=1, checkelbo=1, printelbo=False, cgiter=5)
    equal_states(back.state, g.state, fields, "DTM resumed on the card")
    print(f"DTM checkpoint on the card (M={g.M}, T={g.T}, K={g.K}): save {save_s:.3f} s, "
          f"{size / 2**20:.2f} MiB, load {load_s:.3f} s; bitwise equal, and after one more step")
    print(f"DTM phase: wall {time.perf_counter() - t_phase:.1f} s; launches of the mac run "
          f"{launches}; card {smi}")
    return launches, sc


def hmtm_state(K, B, V, dev, seed):
    """Random emission table (beta + eps)ᵀ [V, K], eta, alpha and a
    per-document state tau [B, K], gamma [B, K, K] (seeded numpy)."""
    import numpy as np
    import torch

    from topicmodelsvb_jl_torch.utils.numerics import EPSILON

    r = np.random.default_rng(seed)
    t = lambda a: torch.tensor(np.ascontiguousarray(a), dtype=torch.float32, device=dev)
    return (t(r.dirichlet(np.ones(V), size=K).T + EPSILON), t(r.uniform(0.5, 2.0, K)),
            t(r.uniform(0.5, 2.0, (K, K))), t(r.uniform(0.5, 3.0, (B, K))),
            t(r.uniform(0.5, 3.0, (B, K, K))))


def hmtm_chunks(bucketed, V, dev) -> list:
    """Phase 9's four chunks, each (label, K, viter, the shared-memory mode
    the kernel must pick, hmtm_estep's arguments): the first 1024
    documents of the widest NSF bucket with unit counts at K = 25 and at K
    = 100, 128 synthetic documents of 3,000-4,096 tokens (L = 4,096, the
    messages past shared memory), and 256 documents of L = 64 holding an
    empty document, a one-token one, one whose first 5 slots are padding,
    and 8 rows with doc_mask 0 (4 of them with tokens)."""
    import numpy as np
    import torch

    from topicmodelsvb_jl_torch.ops.packing import unit_counts

    put = lambda a, dt=torch.float32: torch.as_tensor(np.ascontiguousarray(a), dtype=dt).to(dev)
    seg = unit_counts(bucketed).segments[0]
    nsf = (put(seg.terms[:1024], torch.int32), put(seg.counts[:1024] > 0),
           put(seg.doc_mask[:1024]))
    r = np.random.default_rng(43)
    n = r.integers(3000, 4097, size=128)
    tm_long = (np.arange(4096)[None, :] < n[:, None])
    long_ = (put(np.minimum((V * r.random((128, 4096)) ** 3).astype(np.int32), V - 1) * tm_long,
                 torch.int32), put(tm_long), torch.ones(128, device=dev))
    n = r.integers(20, 65, size=256)
    n[0], n[1] = 0, 1
    tm_sp = np.arange(64)[None, :] < n[:, None]
    tm_sp[2, :5] = False
    tm_sp[-4:] = False
    dm = np.ones(256)
    dm[-8:] = 0.0
    special = (put((V * r.random((256, 64))).astype(np.int32) * tm_sp, torch.int32), put(tm_sp),
               put(dm))
    out = []
    for label, (terms, tmask, doc_mask), K, viter, mode, seed in (
            (f"widest NSF bucket L={seg.L}", nsf, 25, 10, 0, 44),
            ("L=4096 messages in device memory", long_, 25, 3, 1, 45),
            (f"widest NSF bucket L={seg.L}, K=100", nsf, 100, 10, 1, 46),
            ("empty, one-token, padded-first and doc_mask 0 documents, L=64", special, 25, 10,
             0, 47)):
        betaT, eta, alpha, tau, gamma = hmtm_state(K, terms.shape[0], V, dev, seed)
        out.append((label, K, viter, mode,
                    (betaT, terms, tmask, doc_mask, eta, alpha, tau, gamma)))
    return out


def compare_hmtm(label, K, viter, mode, args, dev, calls=(N_KERNEL, 3)) -> tuple:
    """hmtm_estep and hmtm_logz against their plain versions on one chunk:
    the records (``record``, ``calls`` = time_calls's n and reps) and the
    kernel's r."""
    import torch

    from topicmodelsvb_jl_torch.kernels import _build
    from topicmodelsvb_jl_torch.kernels import hmtm_estep as hmtm_mod
    from topicmodelsvb_jl_torch.kernels.hmtm_estep import (
        hmtm_estep, hmtm_estep_ref, hmtm_logz, hmtm_logz_ref,
    )

    betaT, terms, tmask, doc_mask, eta, alpha, tau, gamma = args
    B, L = terms.shape
    got_mode = _build.function("tmvb_hmtm_estep_mode", [ctypes.c_int64] * 2)(L, K)
    need(got_mode == mode, f"hmtm_estep {label}: shared-memory mode {got_mode}, want {mode}")
    kw = dict(viter=viter, vtol=1.0 / K**2)
    got = hmtm_estep(*args, **kw)
    # the plain versions take seconds a call: timed on the run compared
    want, plain_s = timed(lambda: hmtm_estep_ref(*args, **kw))
    err = close(got, want, ("tau", "gamma", "r"), f"hmtm_estep {label}")
    pad = doc_mask == 0   # no pass: the state as given (r is computed on every row)
    need(torch.equal(got[0][pad], tau[pad]) and torch.equal(got[1][pad], gamma[pad]),
         f"hmtm_estep {label}: a doc_mask 0 document's state moved")
    need(bool(torch.all(got[2][tmask == 0] == 0)), f"hmtm_estep {label}: r on padding")
    need(all(torch.equal(a, b) for a, b in zip(got, hmtm_estep(*args, **kw))),
         f"hmtm_estep {label}: not bitwise repeatable")
    zargs = (betaT, terms, tmask, got[0], got[1])
    z = hmtm_logz(*zargs)
    zr, zplain_s = timed(lambda: hmtm_logz_ref(*zargs))
    need(torch.equal(z, hmtm_logz(*zargs)), f"hmtm_logz {label}: not bitwise repeatable")
    zerr = float((z - zr).abs().max())
    need(bool(torch.all(torch.isfinite(z))) and bool(torch.all((z - zr).abs() <= 1e-5 * zr.abs())),
         f"hmtm_logz {label}: off by {zerr} (rel {float(((z - zr).abs() / zr.abs()).max())})")
    # the work this run's data needs: each pass is 6 K² flops a real slot
    # (the forward's A a, the backward's Aᵀ g and its S update), the final
    # pass 4 K²; the passes each document ran come from the plain loop
    real = tmask.sum(1)
    n_real = float(real.sum())
    work = fixpoint_work(hmtm_mod, hmtm_estep_ref, args, kw, real)
    uniq = n_unique(terms, tmask > 0)
    est = record(err, time_calls(lambda: hmtm_estep(*args, **kw), *calls),
                 (plain_s * 1e3, plain_s * 1e3),
                 bound_ms(4 * (uniq * K + 2 * B * L + B + K + K * K + 2 * B * K + 2 * B * K * K
                               + B * L * K), 6 * K * K * work + 4 * K * K * n_real))
    lz = record(zerr, time_calls(lambda: hmtm_logz(*zargs), *calls),
                (zplain_s * 1e3, zplain_s * 1e3),
                bound_ms(4 * (uniq * K + 2 * B * L + B * K + B * K * K + B), 2 * K * K * n_real))
    print(f"kernels HMTM {label}: B={B} L={L} K={K} viter={viter} real slots={int(n_real)} "
          f"shared-memory mode {got_mode}, passes a real slot {work / max(n_real, 1):.2f} | "
          f"hmtm_estep {times(est)} | hmtm_logz {times(lz)}, rel err "
          f"{float(((z - zr).abs() / zr.abs().clamp_min(1e-30)).max()):.3e} (plain: one call "
          "on the host clock)")
    return est, lz, got[2]


def hmtm_held_out(corp, n):
    """The last ``n`` documents in token order, keeping the terms an
    earlier document holds, and the documents before them."""
    import topicmodelsvb_jl_torch as tt

    seen = {t for d in corp.docs[:-n] for t in d.terms}
    test = []
    for d in corp.docs[-n:]:
        terms = [t for t in d.terms if t in seen]
        test.append(tt.Document(terms=terms, counts=[1] * len(terms)))
    return (tt.Corpus(docs=corp.docs[:-n], vocab=corp.vocab),
            tt.Corpus(docs=test, vocab=corp.vocab))


def hmtm_phase(kc, smi, dev) -> tuple:
    """Phase 9, HMTM: the kernels on four chunks, the NSF-scale main path,
    a small HMTM card against CPU and the user path; returns the main
    path's launches and the kernels' and the scatter's records."""
    import numpy as np
    import torch

    import topicmodelsvb_jl_torch as tt
    from topicmodelsvb_jl_torch import convert
    from topicmodelsvb_jl_torch.engine import HostReads
    from topicmodelsvb_jl_torch.kernels.hmtm_estep import hmtm_estep, hmtm_logz
    from topicmodelsvb_jl_torch.kernels.scatter_rows import scatter_rows
    from topicmodelsvb_jl_torch.ops.packing import unit_counts
    from topicmodelsvb_jl_torch.validate import check_model

    t_phase = time.perf_counter()
    V = kc["V"]
    chunks = hmtm_chunks(kc["bucketed"], V, dev)
    res = [compare_hmtm(*c, dev) for c in chunks]
    terms, tmask = chunks[0][4][1:3]
    sc = compare_scatter(V, res[0][2].reshape(-1, 25), terms, tmask > 0, dev,
                         f"HMTM r rows, {chunks[0][0]} (W=25)")
    est, lz = [r[0] for r in res], [r[1] for r in res]
    del chunks, res, terms, tmask

    # the main path: NSF with unit counts, K = 25, viter 10, no device=
    kernels = (hmtm_estep, hmtm_logz, scatter_rows)

    hpk = unit_counts(kc["packed"])
    rt = tt.RuntimeConfig(chunk_docs=1024, dtype="float32")
    model, build_s = timed(lambda: tt.HMTM(hpk, 25, rt, seed=7))
    need(model.device.type == "cuda" and model.state.gamma.is_cuda, "HMTM without device= not on CUDA")
    for k in kernels:
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    _, wall = timed(lambda: model.train(iter=3, checkelbo=1, viter=10))
    launches = {k.__name__: k.launches for k in kernels}
    trace = model.trainer.trace
    deltas = [x.delta_elbo for x in trace]
    need(len(deltas) == 3 and all(d > 0 for d in deltas[1:]), f"HMTM NSF: ∆elbo {deltas}")
    check_model(model)
    n_chunks = n_chunks_of(model)
    want = {"hmtm_estep": 3 * n_chunks, "hmtm_logz": 4 * n_chunks,
            "scatter_rows": 3 * scatters_of(model)}
    need(launches == want, f"HMTM NSF: launches {launches}, want {want}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    tr, st = model.trainer, model.state
    step = tr.step_fn
    sweep_out, estep_s = timed(lambda: step.sweep(st, *tr.data[:3]))
    _, newton_s = timed(lambda: step.update(st.eta, st.alpha, *sweep_out[2:], tr.data[3]))
    s1, step_s = timed(lambda: step(st, *tr.data))
    with HostReads() as reads:
        s2 = step(st, *tr.data)
    _, elbo_s = timed(lambda: tr.elbo_fn(st, *tr.elbo_data))
    fields = ("eta", "alpha", "beta", "tau", "gamma")
    equal_states(s1, s2, fields, "HMTM NSF: one step from one state, twice")
    need(model.tau.shape == (hpk.M, 25) and np.isfinite(model.gamma).all(), "HMTM tau/gamma")
    print(f"main path HMTM NSF: M={model.M} V={model.V} K=25 chunks={n_chunks} widths="
          f"{[s.L for s in model.packed.segments]}; HMTM(packed, 25) in {build_s:.2f} s; "
          f"train(iter=3, checkelbo=1, viter=10) {wall:.2f} s; ∆elbo "
          f"{', '.join(f'{d:.3f}' for d in deltas)}; step+ELBO "
          f"{', '.join(f'{x.step_time_s:.4f}' for x in trace)} s; step alone {step_s:.4f} s "
          f"= {model.M / step_s:.0f} docs/s (E-step sweep {estep_s:.4f} s, eta/alpha Newtons and "
          f"beta {newton_s:.4f} s), ELBO pass {elbo_s * 1e3:.2f} ms; host reads a step "
          f"{reads.n}; launches {launches}; peak mem {peak:.2f} GiB; card {smi}")
    del sweep_out, s1, s2, tr, st
    same_seed_steps(lambda: tt.HMTM(hpk, 25, rt, seed=7), fields, "HMTM")
    del model

    # a small HMTM on the card against the CPU in f64, from one init
    small = unit_counts(tt.synth_packed_nsf_scale(M=2000, V=500, mean_terms=30, seed=5))
    card_vs_cpu("HMTM", lambda rt_, d: tt.HMTM(small, 10, rt_, device=d, seed=1),
                convert.hmtm_state_to_numpy, convert.hmtm_state_from_numpy, fields, dev)

    # the user path: a Corpus, expanded to one entry a token
    def step_(label, fn):
        for k in kernels:
            k.launches = 0
        out, s = timed(fn)
        counts = {k.__name__: k.launches for k in kernels if k.launches}
        print(f"HMTM user path {label}: {s:.3f} s, launches {counts}")
        return out, counts

    nsf, _ = step_("load_nsf(subset=4096)", lambda: tt.load_nsf(subset=4096))
    try:
        tt.HMTM(nsf, 25)
        need(False, "HMTM accepted a condensed corpus")
    except ValueError as e:
        need("order-preserving" in str(e), f"HMTM on a condensed corpus: {e}")
    step_("expand_corp", lambda: tt.expand_corp(nsf))
    train, test = hmtm_held_out(nsf, 256)
    h, counts = step_("HMTM(train, 25) train(iter=2)",
                      lambda: tt.HMTM(train, 25, seed=7).train(iter=2, printelbo=False))
    n_ch = n_chunks_of(h)
    need(h.device.type == "cuda" and counts.get("hmtm_estep") == 2 * n_ch
         and counts.get("hmtm_logz") == 3 * n_ch, f"HMTM user path: launches {counts}")
    need(h.trainer.trace[-1].delta_elbo > 0, "HMTM user path: ∆elbo not positive")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        h.showtopics(V=8, cols=5, topics=range(1, 6))
    lines = buf.getvalue().splitlines()
    need(len(lines) == 9, f"showtopics: {lines}")
    for line in lines:
        print(f"  {line}")
    T = h.transdist(1)
    need(T.shape == (25, 25) and np.allclose(T.sum(0), 1.0, atol=1e-5), "transdist(1)")
    pred, counts = step_("predict(test, h)", lambda: tt.predict(test, h))
    need(counts.get("hmtm_estep") == n_chunks_of(pred) and
         counts.get("scatter_rows") == scatters_of(pred), f"HMTM predict launches {counts}")
    cpu = tt.HMTM(test, 25, tt.RuntimeConfig(dtype="float64"), device="cpu", seed=7)
    cpu.state = dataclasses.replace(cpu.state, **{f: getattr(h.state, f).double().cpu()
                                                 for f in ("eta", "alpha", "beta")})
    pc, _ = step_("predict(test, h on the CPU in f64)", lambda: tt.predict(test, cpu))
    worst = {}
    for f in ("tau", "gamma"):
        a, b = getattr(pred, f).astype(np.float64), getattr(pc, f)
        need(np.all(np.abs(a - b) <= ATOL + RTOL * np.abs(b)),
             f"HMTM predict: card against CPU {f} off by {np.abs(a - b).max()}")
        worst[f] = float(np.max(np.abs(a - b) / np.abs(b)))
    print(f"HMTM user path predict card f32 vs CPU f64: max rel err tau {worst['tau']:.3e}, "
          f"gamma {worst['gamma']:.3e} (rtol {RTOL}, atol {ATOL})")
    ppl, _ = step_("perplexity(test, h)", lambda: tt.perplexity(test, h))
    need(math.isfinite(ppl) and 1.0 < ppl < h.V, f"HMTM perplexity {ppl}")
    gen, _ = step_("gencorp(h, M=100, laplace_smooth=1e-6, seed=1)",
                   lambda: tt.gencorp(h, M=100, laplace_smooth=1e-6, seed=1))
    need(len(gen) == 100 and all(c == 1 for d in gen.docs for c in d.counts), "HMTM gencorp")
    g, counts = step_("HMTM(gencorp) one step", lambda: tt.HMTM(gen, 25, seed=7).train(
        iter=1, checkelbo=1, printelbo=False))
    need(counts.get("hmtm_estep") == n_chunks_of(g) and math.isfinite(g.elbo),
         f"HMTM one step on the drawn corpus: launches {counts}, elbo {g.elbo}")
    print(f"HMTM user path: M={h.M} V={h.V} mean tokens {np.mean(h.N):.1f}, widths "
          f"{[s.L for s in h.packed.segments]}; transdist(1) diagonal mean "
          f"{float(np.mean(np.diag(T))):.4f}; perplexity {ppl:.2f}; gencorp mean length "
          f"{np.mean([len(d) for d in gen.docs]):.1f}")

    # a checkpoint on the card: iteration 1 saved, loaded, one more step
    os.makedirs(os.path.join(ROOT, "_tmp"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "_tmp")) as tmp:
        path = os.path.join(tmp, "hmtm.npz")
        first = tt.HMTM(train, 25, seed=7).train(iter=1, printelbo=False)
        _, save_s = timed(lambda: tt.save_checkpoint(path, first))
        back, load_s = timed(lambda: tt.load_checkpoint(path, train))
        size = os.path.getsize(path)
    need(back.device.type == "cuda" and back.trained_iters == 1, "HMTM checkpoint: model")
    equal_states(back.state, first.state, fields + ("elbo",), "HMTM checkpoint on the card")
    back.train(iter=1, printelbo=False)
    need([x.k for x in back.trainer.trace] == [2], "HMTM resume: iteration numbers")
    equal_states(back.state, h.state, fields, "HMTM resume against the straight run")
    print(f"HMTM checkpoint on the card: save {save_s:.3f} s, {size / 2**20:.2f} MiB, load "
          f"{load_s:.3f} s; the resume of 1 iteration from iteration 1 bitwise equal to the "
          f"straight 2-iteration run")
    print(f"HMTM phase: wall {time.perf_counter() - t_phase:.1f} s; card {smi}")
    return launches, dict(estep=est, logz=lz, scatter=[sc])


def stream_equal(a, b, label) -> None:
    """Two streaming models bitwise equal: globals, host state and trace."""
    import numpy as np
    import torch

    for n in a._globals:
        need(torch.equal(getattr(a, n), getattr(b, n)), f"{label}: {n} differs")
    for n in a._doc_state:
        need(np.array_equal(getattr(a, n), getattr(b, n)), f"{label}: {n} differs")
    need(a.trace == b.trace, f"{label}: traces differ: {a.trace} vs {b.trace}")


def instrument(model) -> dict:
    """Wrap a streaming model's sweep and bound pass: each call's wall
    (between synchronizes) and, for the sweep, its copies (bytes each way,
    the host's seconds blocked on copy events)."""
    import torch

    rec = dict(sweep=[], elbo=[])
    sweep, bound = model._streamed_sweep, model._sweep_elbo

    def timed_sweep(stats):
        stage = model._stage
        torch.cuda.synchronize()
        stage.reset_counters()
        t0 = time.perf_counter()
        out = sweep(stats)
        torch.cuda.synchronize()
        rec["sweep"].append(dict(wall=time.perf_counter() - t0, h2d=stage.h2d_bytes,
                                 d2h=stage.d2h_bytes, wait_s=stage.wait_s))
        return out

    def timed_bound():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = bound()
        rec["elbo"].append(time.perf_counter() - t0)
        return out

    model._streamed_sweep, model._sweep_elbo = timed_sweep, timed_bound
    return rec


def profiled_copies(model) -> str:
    """One more sweep of ``model`` under ``torch.profiler``: the device time
    of its copies each way, from the profiler's Memcpy rows."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        model._streamed_sweep(model._zero_stats())
        torch.cuda.synchronize()
    dev_us = lambda e: (getattr(e, "self_device_time_total", None)
                        or getattr(e, "self_cuda_time_total", 0))
    out = []
    for way in ("HtoD", "DtoH"):
        rows = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and e.key.startswith(f"Memcpy {way}")]
        us = sum(dev_us(e) for e in rows)
        out.append(f"{way} {us / 1e3:.2f} ms device in {sum(e.count for e in rows)} copies"
                   if us else f"{way} not measured (no device rows)")
    return ", ".join(out)


def scatter_plans_launching(model) -> int:
    """Scatter launches a sweep: the plans of the model's batches that keep
    a slot (a plan that keeps nothing launches nothing)."""
    return sum(p.n_pieces > 0 for _, _, host in model._plans.values()
               for ps in host for p in ps)


def pad_rows(packed, M_pad: int):
    """A dense PackedCorpus with padding rows appended up to ``M_pad``."""
    import numpy as np

    def pad(a):
        if a is None:
            return None
        out = np.zeros((M_pad,) + a.shape[1:], a.dtype)
        out[: a.shape[0]] = a
        return out

    return dataclasses.replace(packed, **{f: pad(getattr(packed, f)) for f in (
        "terms", "counts", "doc_mask", "N", "C", "readers", "ratings", "R")})


def stream_card_vs_cpu(label, make, norm_fields=(), train_kw=None) -> None:
    """A small streaming model trained 2 iterations on the card (f32,
    kernels) and on the CPU (f64, plain versions) from one init: the
    bound to 1e-4, each global at rtol 1e-3 / atol 1e-6 (as phase 3), the
    ``norm_fields`` by the norm of the difference to 2e-3 (as phase 8)."""
    import numpy as np
    import torch

    from topicmodelsvb_jl_torch import convert

    card = make("cuda", torch.float32)
    cpu = make("cpu", torch.float64)
    convert.streaming_from(cpu, card)
    card.train(iter=2, checkelbo=1, printelbo=False, **(train_kw or {}))
    cpu.train(iter=2, checkelbo=1, printelbo=False, **(train_kw or {}))
    ge, ce = [t[1] for t in card.trace], [t[1] for t in cpu.trace]
    rel = max(abs(a - b) / abs(b) for a, b in zip(ge, ce))
    need(rel <= 1e-4, f"small {label}: f32 card bound {ge} vs f64 CPU {ce}")
    worst = 0.0
    for n in card._globals:
        a = getattr(card, n).double().cpu().numpy()
        b = getattr(cpu, n).cpu().numpy()
        if n in norm_fields:
            err = float(np.linalg.norm(a - b) / np.linalg.norm(b))
            need(err <= 2e-3, f"small {label}: {n} off by {err:.3e} by the norm")
        else:
            need(np.allclose(a, b, rtol=1e-3, atol=1e-6), f"small {label}: {n} off by "
                 f"{float(np.max(np.abs(a - b)))}")
            err = float(np.max(np.abs(a - b) / (1e-6 + np.abs(b))))
        worst = max(worst, err)
    print(f"small {label} (M={card.M}, K={card.K}, 2 iterations, batch {card.batch_docs}): "
          f"card f32 vs CPU f64 bound rel diff {rel:.3e}, worst global rel diff {worst:.3e}")


def streaming_phase(smi, dev, kc, lda_step_s) -> tuple:
    """Phase 10, host-streamed training: StreamingLDA at NSF scale (the
    main path) with its checks, then the six other families; returns the
    main runs' launches and the records of the kernels held on a dense
    NSF chunk."""
    import numpy as np
    import torch

    import topicmodelsvb_jl_torch as tt
    from topicmodelsvb_jl_torch import streaming as st
    from topicmodelsvb_jl_torch.kernels.ctpf_estep import ctpf_estep
    from topicmodelsvb_jl_torch.kernels.flda_estep import flda_estep
    from topicmodelsvb_jl_torch.kernels.hmtm_estep import hmtm_estep, hmtm_logz
    from topicmodelsvb_jl_torch.kernels.lda_elbo import lda_elbo_tok
    from topicmodelsvb_jl_torch.kernels.lda_estep import lda_estep
    from topicmodelsvb_jl_torch.kernels.scatter_rows import scatter_rows
    from topicmodelsvb_jl_torch.ops.packing import load_packed, save_packed, unit_counts

    t_phase = time.perf_counter()
    kernels = (lda_estep, lda_elbo_tok, scatter_rows, flda_estep, ctpf_estep, hmtm_estep,
               hmtm_logz)
    launches = {k.__name__: 0 for k in kernels}

    def run(fn) -> dict:
        """``fn()`` with every count set to 0 just before and read just after."""
        for k in kernels:
            k.launches = 0
        fn()
        torch.cuda.synchronize()
        got = {k.__name__: k.launches for k in kernels if k.launches}
        for n, v in got.items():
            launches[n] += v
        return got

    def sweeps(rec) -> str:
        return "; ".join(f"{r['wall']:.3f} s" for r in rec["sweep"])

    # the corpus: dense, 8192-document padding (16 batches of 8 chunks)
    t0 = time.perf_counter()
    packed = tt.synth_packed_nsf_scale(chunk_docs=8192)
    K, V, M = 100, packed.V, packed.M
    need((M, packed.M_pad, V) == (128_804, 131_072, 25_319),
         f"streaming corpus: M={M} M_pad={packed.M_pad} V={V}")
    n_chunks = packed.M_pad // 1024
    print(f"streaming corpus NSF dense: M={M} M_pad={packed.M_pad} V={V} L={packed.L} "
          f"({time.perf_counter() - t0:.1f} s)")

    # the path's kernels against their plain versions on a dense chunk
    put = lambda a, dt: torch.as_tensor(np.ascontiguousarray(a), dtype=dt).to(dev)
    dense = (put(packed.terms[:1024], torch.int32), put(packed.counts[:1024], torch.float32),
             put(packed.doc_mask[:1024], torch.float32))
    kr = compare_kernels(dense, V, K, dev, f"dense NSF chunk 1024 x {packed.L}")
    sc = compare_scatter(V, kr.pop("w").reshape(-1, K), dense[0], dense[1] > 0, dev,
                         f"LDA w, dense NSF chunk L={packed.L}")
    del dense

    # the main path: StreamingLDA(packed, 100), f32, JAX package defaults
    make = lambda **kw: st.StreamingLDA(packed, K, chunk_docs=1024, seed=7, **kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    a = make(batch_docs=8192)
    need(a.device.type == "cuda" and a.beta.is_cuda, "StreamingLDA without device= not on CUDA")
    rec = instrument(a)
    got = run(lambda: a.train(iter=3, checkelbo=1, printelbo=False))
    peak = torch.cuda.max_memory_allocated() - base
    deltas = [t[2] for t in a.trace]
    need(len(deltas) == 3 and all(d > 0 for d in deltas), f"StreamingLDA NSF: ∆elbo {deltas}")
    want = {"lda_estep": 3 * n_chunks, "lda_elbo_tok": 4 * n_chunks,
            "scatter_rows": 3 * scatter_plans_launching(a)}
    need(got == want, f"StreamingLDA NSF: launches {got}, want {want}")
    need(np.isfinite(a.gamma).all() and np.isfinite(a.beta.cpu().numpy()).all(),
         "StreamingLDA NSF: state not finite")
    # O(batch) bound from the inputs: globals, statistic and tables, two
    # staging slots (a batch's terms, counts, doc_mask, 3 state rows and
    # its largest flattened plans up, the 3 state rows down, each array
    # padded to 256 bytes), two chunks' rows w
    VK = 4 * V * K
    plan_b = max(flat.nbytes for flat, _, _ in a._plans.values())
    slot_in = 8192 * (packed.L * (4 + 4) + 4 + 3 * K * 4) + plan_b + 7 * 256
    slot_out = 8192 * 3 * K * 4 + 3 * 256
    staged = sum(s["cap_in"] + s["cap_out"] for s in a._stage.slots)
    need(len(a._plans) == packed.M_pad // 8192 and staged <= 2 * (slot_in + slot_out),
         f"StreamingLDA NSF: staging slots {staged} bytes above two batches "
         f"{2 * (slot_in + slot_out)}")
    w_chunk = 4 * 1024 * packed.L * K
    bound = 8 * VK + 2 * (slot_in + slot_out) + 2 * w_chunk
    resident = (packed.terms.nbytes + packed.counts.nbytes + packed.doc_mask.nbytes
                + 3 * packed.M_pad * K * 4)
    need(peak <= bound, f"StreamingLDA NSF: peak {peak} bytes above the O(batch) bound {bound}")
    mib = lambda x: f"{x / 2**20:.1f} MiB"
    r2 = rec["sweep"][1:]
    sweep_s = statistics.median(r["wall"] for r in r2)
    print(f"main path StreamingLDA NSF: batch_docs 8192 (16 batches of 8 chunks), K={K}, "
          f"train(iter=3, checkelbo=1): ∆elbo {', '.join(f'{d:.3f}' for d in deltas)}; "
          f"final elbo {a.elbo:.3f}; launches {got}; card {smi}")
    print(f"StreamingLDA sweeps {sweeps(rec)} (the first builds the plans: "
          f"{a.plan_build_s:.3f} s on the host, {mib(a.plan_cache_bytes)} kept in host "
          f"memory); bound passes {', '.join(f'{x:.3f}' for x in rec['elbo'])} s; sweep "
          f"{sweep_s:.3f} s = {M / sweep_s:.0f} docs/s against the in-memory LDA step's "
          f"{lda_step_s:.4f} s = {M / lda_step_s:.0f} docs/s (phase 4); card {smi}")
    print("StreamingLDA copies a sweep (sweeps 2-3): " + "; ".join(
        f"up {mib(r['h2d'])}, down {mib(r['d2h'])}, host blocked on copy events "
        f"{r['wait_s']:.3f} s of {r['wall']:.3f} s"
        for r in r2) + f"; card {smi}")
    print(f"StreamingLDA device memory: peak {mib(peak)} above the {mib(base)} already "
          f"allocated; O(batch) bound 8·V·K·4 (globals, statistic, the sweep's and the "
          f"bound's tables) {mib(8 * VK)} + two staging slots 2·({mib(slot_in)} up with "
          f"{mib(plan_b)} of plans, {mib(slot_out)} down) (allocated {mib(staged)}) + two "
          f"chunks' rows w {mib(2 * w_chunk)} = {mib(bound)}; the in-memory LDA keeps "
          f"{mib(resident)} of corpus and state resident; card {smi}")

    # against the in-memory LDA from the same init, after 3 iterations
    mem = tt.LDA(packed, K, tt.RuntimeConfig(chunk_docs=1024), seed=7)
    mem.train(iter=3, checkelbo=1, printelbo=False)
    b_err = float(torch.linalg.norm(a.beta - mem.state.beta) / torch.linalg.norm(mem.state.beta))
    al_err = float(torch.max(torch.abs(a.alpha - mem.state.alpha) / mem.state.alpha))
    e_err = abs(a.elbo - mem.elbo) / abs(mem.elbo)
    need(b_err <= 1e-3 and al_err <= 1e-3 and e_err <= 1e-5,
         f"StreamingLDA against the in-memory LDA: beta {b_err:.3e} by the norm, alpha "
         f"{al_err:.3e}, elbo {e_err:.3e}")
    print(f"StreamingLDA against the in-memory LDA (bucketed, same init) after 3 iterations: "
          f"beta {b_err:.3e} by the norm (tolerance 1e-3), alpha max rel {al_err:.3e} "
          f"(1e-3), elbo rel {e_err:.3e} (1e-5); card {smi}")
    del mem

    b = make(batch_docs=16384)
    b.train(iter=3, checkelbo=1, printelbo=False)
    stream_equal(b, a, "StreamingLDA batch_docs 16384 against 8192")
    del b
    e = make(batch_docs=8192)
    e.train(iter=3, checkelbo=1, printelbo=False)
    stream_equal(e, a, "StreamingLDA: two same-seed runs")
    print(f"StreamingLDA copies of a 4th sweep under torch.profiler: {profiled_copies(e)}; "
          f"card {smi}")
    del e
    os.makedirs(os.path.join(ROOT, "_tmp"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "_tmp")) as tmp:
        c = make(batch_docs=8192)
        c.train(iter=2, checkelbo=1, printelbo=False)
        path = os.path.join(tmp, "stream.npz")
        _, save_s = timed(lambda: c.save(path))
        size = os.path.getsize(path)
        c, load_s = timed(lambda: st.load(path, packed))
        need(c.device.type == "cuda" and c.trained_iters == 2, "StreamingLDA load")
        c.train(iter=1, checkelbo=1, printelbo=False)
        stream_equal(c, a, "StreamingLDA resumed from iteration 2")
        del c
        _, pack_s = timed(lambda: save_packed(os.path.join(tmp, "corpus"), packed))
        disk = load_packed(os.path.join(tmp, "corpus"))
        need(isinstance(disk.terms, np.memmap), "load_packed did not memory-map")
        d = st.StreamingLDA(disk, K, batch_docs=8192, chunk_docs=1024, seed=7,
                            state_dir=os.path.join(tmp, "state"))
        need(isinstance(d.gamma, np.memmap), "state_dir did not memory-map the state")
        drec = instrument(d)
        d.train(iter=3, checkelbo=1, printelbo=False)
        stream_equal(d, a, "StreamingLDA state_dir on a load_packed corpus against RAM")
        del d
    print(f"StreamingLDA: batch_docs 16384 bitwise equal to 8192; two same-seed runs bitwise "
          f"equal; save after iteration 2 ({save_s:.2f} s, {mib(size)}), load ({load_s:.2f} "
          f"s) and one more iteration bitwise equal to the straight run; save_packed "
          f"{pack_s:.2f} s, the state_dir run on the load_packed memory maps bitwise equal "
          f"to the RAM run (sweeps {sweeps(drec)}); card {smi}")

    o = make(batch_docs=8192)
    _, online_s = timed(lambda: o.train_online(epochs=1, checkelbo=1, printelbo=False))
    need(len(o.trace) == 1 and o.trace[0][2] > 0, f"StreamingLDA train_online: {o.trace}")
    online_delta = o.trace[0][2]
    del o
    m = a.to_model()
    td = m.topicdist(np.arange(1, M + 1))
    g = a.gamma[:M] / a.gamma[:M].sum(1, keepdims=True)
    need(np.allclose(td, g, rtol=1e-5, atol=1e-7), "StreamingLDA to_model topicdist")
    need(np.array_equal(m.gamma, a.gamma[:M]), "StreamingLDA to_model gamma")
    print(f"StreamingLDA: train_online(epochs=1) {online_s:.2f} s, ∆elbo {online_delta:.3f}; "
          f"to_model() topicdist equal to the streamed gamma (max abs diff "
          f"{float(np.max(np.abs(td - g))):.2e}); card {smi}")
    del a, m, td, g

    # the other six families, each at its configuration's width
    fam = {}

    def family(label, model_fn, train_kw, expect, monotone_from=1):
        m1 = model_fn()
        rec_ = instrument(m1)
        got_ = run(lambda: m1.train(iter=3, checkelbo=1, printelbo=False, **train_kw))
        d_ = [t[2] for t in m1.trace]
        need(len(d_) == 3 and all(x > 0 for x in d_[monotone_from:]), f"{label}: ∆elbo {d_}")
        ch = m1.M_rows // m1.chunk_docs
        for k, (per_sweep, per_bound) in expect.items():
            w = 3 * per_sweep(m1, ch) + 4 * per_bound(ch)
            need(got_.get(k) == w, f"{label}: {k} launches {got_.get(k)}, want {w}")
        m2 = model_fn()
        m2.train(iter=3, checkelbo=1, printelbo=False, **train_kw)
        stream_equal(m2, m1, f"{label}: two same-seed runs")
        fam[label] = statistics.median(r["wall"] for r in rec_["sweep"][1:])
        print(f"{label}: M={m1.M} V={m1.V} K={m1.K} batch_docs {m1.batch_docs} chunk "
              f"{m1.chunk_docs}: ∆elbo {', '.join(f'{x:.3f}' for x in d_)}; sweeps "
              f"{sweeps(rec_)}; bound passes {', '.join(f'{x:.3f}' for x in rec_['elbo'])} s; "
              f"plans {m1.plan_build_s:.3f} s; launches {got_}; same-seed runs bitwise "
              f"equal; card {smi}")

    per_chunk = lambda m_, ch: ch
    no = lambda ch: 0
    scat = lambda m_, ch: scatter_plans_launching(m_)
    fpk = tt.synth_packed_nsf_scale(M=16_384, chunk_docs=8192)
    family("StreamingFLDA NSF V, 16,384 documents",
           lambda: st.StreamingFLDA(fpk, 100, batch_docs=8192, chunk_docs=1024, seed=7), {},
           {"flda_estep": (per_chunk, no), "scatter_rows": (scat, no)})
    cpk = pad_rows(kc["cpk"], 18_432)
    family("StreamingCTPF CiteULike", lambda: st.StreamingCTPF(
        cpk, 100, batch_docs=6144, chunk_docs=1024, seed=7), {},
        {"ctpf_estep": (per_chunk, no), "scatter_rows": (scat, no)})
    mpk = tt.synth_packed_nsf_scale(M=8192, chunk_docs=4096)
    family("StreamingCTM NSF V, 8,192 documents", lambda: st.StreamingCTM(
        mpk, 50, batch_docs=4096, seed=7), {},
        {"lda_elbo_tok": (lambda m_, ch: 0, lambda ch: ch), "scatter_rows": (scat, no)})
    family("StreamingFCTM NSF V, 8,192 documents", lambda: st.StreamingFCTM(
        mpk, 50, batch_docs=4096, seed=7), {}, {"scatter_rows": (scat, no)})
    hpk = unit_counts(fpk)
    family("StreamingHMTM NSF unit counts, 16,384 documents", lambda: st.StreamingHMTM(
        hpk, 25, batch_docs=8192, chunk_docs=1024, seed=7), {},
        {"hmtm_estep": (per_chunk, no), "hmtm_logz": (lambda m_, ch: 0, lambda ch: ch),
         "scatter_rows": (scat, no)})
    mac = mac_corpus(M=8192)
    dpk = tt.pack_corpus(mac, docs_multiple=4096)
    T, sid = st.slices_from_stamps([doc.stamp for doc in mac.docs], 1.0, dpk.M_pad)
    need(T == 12, f"mac slices {T}")
    family("StreamingDTM mac V, T=12, 8,192 documents", lambda: st.StreamingDTM(
        dpk, 20, T, sid, batch_docs=4096, chunk_docs=1024, seed=7), dict(cgiter=10),
        {"scatter_rows": (scat, no)}, monotone_from=0)

    # each family small, on the card against the CPU in f64, from one init
    small = tt.synth_packed_nsf_scale(M=2000, V=500, mean_terms=30, seed=5)
    kw = lambda dev_, dt: dict(batch_docs=1024, chunk_docs=256, dtype=dt, device=dev_, seed=1)
    stream_card_vs_cpu("StreamingLDA", lambda d_, t_: st.StreamingLDA(small, 10, **kw(d_, t_)))
    stream_card_vs_cpu("StreamingFLDA", lambda d_, t_: st.StreamingFLDA(small, 10, **kw(d_, t_)))
    stream_card_vs_cpu("StreamingCTM", lambda d_, t_: st.StreamingCTM(small, 10, **kw(d_, t_)))
    stream_card_vs_cpu("StreamingFCTM", lambda d_, t_: st.StreamingFCTM(small, 10, **kw(d_, t_)))
    stream_card_vs_cpu("StreamingHMTM", lambda d_, t_: st.StreamingHMTM(
        unit_counts(small), 10, **kw(d_, t_)))
    small_c = tt.pack_corpus(tt.synth_corpus(M=1500, V=600, K=8, U=300, seed=3,
                                             mean_tokens=40, mean_terms=25, mean_readers=4),
                             with_readers=True, docs_multiple=512)
    stream_card_vs_cpu("StreamingCTPF", lambda d_, t_: st.StreamingCTPF(
        small_c, 10, batch_docs=512, chunk_docs=256, dtype=t_, device=d_, seed=1))
    # phase 8's small stamped corpus and its card-vs-CPU settings
    small_dtm = tt.synth_corpus(M=1500, V=600, K=8, seed=3, n_slices=5, drift=0.2,
                                mean_tokens=60, mean_terms=40)
    smpk = tt.pack_corpus(small_dtm, docs_multiple=512)
    Ts, ssid = st.slices_from_stamps([doc.stamp for doc in small_dtm.docs], 1.0, smpk.M_pad)
    stream_card_vs_cpu("StreamingDTM", lambda d_, t_: st.StreamingDTM(
        smpk, 10, Ts, ssid, batch_docs=512, chunk_docs=256, dtype=t_, device=d_, seed=1),
        norm_fields=("betahat", "mbeta"), train_kw=dict(cgiter=5, cgtol=0.0))

    print(f"streaming sweeps (median of sweeps 2-3): " + "; ".join(
        f"{k} {v:.3f} s" for k, v in fam.items()) + f"; card {smi}")
    print(f"streaming phase: wall {time.perf_counter() - t_phase:.1f} s; launches {launches}; "
          f"card {smi}")
    return launches, dict(estep=kr["estep"], elbo=kr["elbo"], scatter=sc)


P12_KERNELS = ("lda_estep", "lda_elbo_tok", "flda_estep", "ctpf_estep", "scatter_rows",
               "hmtm_estep", "hmtm_logz")


def p12_counters() -> dict:
    """The seven kernel wrappers by name (each counts its launches)."""
    from topicmodelsvb_jl_torch.kernels import ctpf_estep, flda_estep, hmtm_estep, lda_elbo
    from topicmodelsvb_jl_torch.kernels import lda_estep, scatter_rows

    return {"lda_estep": lda_estep.lda_estep, "lda_elbo_tok": lda_elbo.lda_elbo_tok,
            "flda_estep": flda_estep.flda_estep, "ctpf_estep": ctpf_estep.ctpf_estep,
            "scatter_rows": scatter_rows.scatter_rows, "hmtm_estep": hmtm_estep.hmtm_estep,
            "hmtm_logz": hmtm_estep.hmtm_logz}


def p12_local(model):
    """What n_chunks_of/scatters_of read, for this process's slab."""
    import types

    return types.SimpleNamespace(packed=model.local_packed, chunk_docs=model.chunk_docs)


def parallel_child(mode: str, rank: int, world: int, port: int, tmp: str) -> int:
    """One process of phase 12 (``chip_smoke.py --p12 MODE RANK WORLD PORT
    DIR``): ``gloo`` is one of two ranks sharing the card, ``nccl`` the
    one rank of an NCCL group.  Writes ``DIR/MODE{rank}.npz`` (globals,
    for the bitwise comparison across ranks) and ``.json`` (launches,
    bounds, times, printed lines); any failed check exits non-zero."""
    import numpy as np
    import torch

    from topicmodelsvb_jl_torch.parallel import multihost, shard

    multihost.initialize(f"localhost:{port}", world, rank, backend=mode)
    import topicmodelsvb_jl_torch as tt
    from topicmodelsvb_jl_torch.ops.packing import unit_counts
    from topicmodelsvb_jl_torch.parallel.mesh import make_mesh

    kern = p12_counters()
    arrays, info, lines = {}, {"launches": {}}, []
    tag = f"[{mode} rank {rank}/{world}]"

    def run(fn) -> dict:
        for k in kern.values():
            k.launches = 0
        fn()
        torch.cuda.synchronize()
        got = {n: k.launches for n, k in kern.items() if k.launches}
        for n, v in got.items():
            info["launches"][n] = info["launches"].get(n, 0) + v
        return got

    def keep(prefix, model):
        for f in model.state.__dataclass_fields__:
            if f not in model._per_doc_fields:
                arrays[f"{prefix}/{f}"] = getattr(model.state, f).cpu().numpy()
        info[f"{prefix}/trace"] = [r.elbo for r in model.trainer.trace]

    spk = tt.load_packed(os.path.join(tmp, "nsf"))
    if mode == "nccl":
        # the same model on a mesh of every rank (one, over NCCL) and on
        # this device with no collective: bit for bit equal
        runs = {}
        for name, mesh in (("local", make_mesh(local=True)), ("nccl", None)):
            shard.STATS.reset()
            m = tt.LDA(spk, 100, mesh=mesh, seed=7)
            got = run(lambda: m.train(iter=2, checkelbo=1, printelbo=False))
            runs[name] = (m, dict(shard.STATS.routes), got)
        (a, ra, ga), (b, rb, gb) = runs["local"], runs["nccl"]
        need(ra == {} and set(rb) == {"nccl:cuda"} and sum(rb.values()) > 0,
             f"{tag} collective routes: local {ra}, mesh {rb}")
        need(b._red_mesh is not None and b._n_shards == 1, f"{tag} no NCCL mesh")
        need(ga == gb, f"{tag} launches differ: {ga} vs {gb}")
        for f in a.state.__dataclass_fields__:
            need(torch.equal(getattr(a.state, f), getattr(b.state, f)),
                 f"{tag} LDA {f}: the one-rank NCCL mesh differs from no mesh")
        lines.append(f"{tag} LDA NSF K=100, 2 iterations on the one-rank NCCL mesh: every "
                     f"state field bitwise equal to mesh=None; collectives {rb}; launches {gb}")
    else:
        # 1. LDA at full width, no device= and no mesh=
        m = tt.LDA(spk, 100, seed=7)
        need(m.device.type == "cuda" and m._n_shards == world and m._shard == rank,
             f"{tag} LDA not sharded over the ranks on CUDA")
        loc = p12_local(m)
        n_ch = n_chunks_of(loc)
        got = run(lambda: m.train(iter=3, checkelbo=1, printelbo=False))
        deltas = [r.delta_elbo for r in m.trainer.trace]
        need(len(deltas) == 3 and all(d > 0 for d in deltas), f"{tag} LDA ∆elbo {deltas}")
        want = {"lda_estep": 3 * n_ch, "lda_elbo_tok": 4 * n_ch,
                "scatter_rows": 3 * scatters_of(loc)}
        need(got == want, f"{tag} LDA launches {got}, want {want}")
        need(np.isfinite(m.state.gamma.cpu().numpy()).all(), f"{tag} LDA gamma not finite")
        keep("lda", m)
        steps = [r.step_time_s for r in m.trainer.trace]
        # one more step alone, its collectives timed (the device waited for
        # around each), then put back: the checkpoint is of iteration 3
        tr, st0 = m.trainer, m.state
        shard.STATS.reset()
        shard.STATS.timed = True
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.step_fn(st0, *tr.data)
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
        shard.STATS.timed = False
        coll = dict(calls=shard.STATS.calls, bytes=shard.STATS.bytes,
                    seconds=shard.STATS.seconds, routes=dict(shard.STATS.routes))
        info["lda_step_s"], info["lda_coll"] = step_s, coll
        lines.append(
            f"{tag} LDA NSF K=100: {m.local_packed.M_pad} of {m.packed.M_pad} rows, {n_ch} "
            f"chunks; ∆elbo {', '.join(f'{d:.3f}' for d in deltas)}; launches {got}; step+ELBO "
            f"{', '.join(f'{x:.4f}' for x in steps)} s; one step alone {step_s:.4f} s, of "
            f"which collectives {coll['seconds']:.4f} s ({coll['calls']} calls, "
            f"{coll['bytes'] / 2**20:.1f} MiB sent, routes {coll['routes']})")
        # 4. the directory checkpoint of iteration 3, then one iteration more
        t0 = time.perf_counter()
        tt.save_checkpoint(os.path.join(tmp, "ckpt"), m)
        save_s = time.perf_counter() - t0
        got = run(lambda: m.train(iter=1, checkelbo=1, printelbo=False))
        need(m.trained_iters == 4, f"{tag} LDA resumed to {m.trained_iters}")
        keep("lda_resumed", m)
        lines.append(f"{tag} LDA checkpoint directory written in {save_s:.2f} s; one "
                     f"iteration more: launches {got}")
        del m, tr, st0
        # 5. StreamingLDA, 2 iterations, a save, 1 more
        sm = tt.StreamingLDA(spk, 100, chunk_docs=1024, seed=7)
        need(sm._nproc == world and sm.batch_docs * world == 8192, f"{tag} StreamingLDA rows")
        got = run(lambda: sm.train(iter=2, checkelbo=1, printelbo=False))
        t0 = time.perf_counter()
        sm.save(os.path.join(tmp, "sckpt"))
        ssave_s = time.perf_counter() - t0
        got2 = run(lambda: sm.train(iter=1, checkelbo=1, printelbo=False))
        deltas = [t[2] for t in sm.trace]
        need(len(deltas) == 3 and all(d > 0 for d in deltas), f"{tag} StreamingLDA ∆elbo {deltas}")
        n_sc = sm.M_rows // sm.chunk_docs
        want = {"lda_estep": 2 * n_sc, "lda_elbo_tok": 3 * n_sc,
                "scatter_rows": 2 * scatter_plans_launching(sm)}
        need(got == want, f"{tag} StreamingLDA launches {got}, want {want}")
        for n in sm._globals:
            arrays[f"stream/{n}"] = getattr(sm, n).cpu().numpy()
        info["stream/trace"] = [t[1] for t in sm.trace]
        lines.append(f"{tag} StreamingLDA NSF K=100: {sm.M_rows} of {spk.M_pad} rows, batch "
                     f"{sm.batch_docs} of {sm._batch_docs_global}; ∆elbo "
                     f"{', '.join(f'{d:.3f}' for d in deltas)}; launches {got} then {got2}; "
                     f"save at iteration 2 {ssave_s:.2f} s")
        del sm
        # 3. the six other families at phase 10's depths, 2 iterations
        fpk = tt.synth_packed_nsf_scale(M=16_384, chunk_docs=8192)
        mpk = tt.synth_packed_nsf_scale(M=8192, chunk_docs=4096)
        cases = (
            ("fLDA NSF V, 16,384 documents", lambda: tt.fLDA(fpk, 100, seed=7), {}, 1,
             lambda m_, n_: {"flda_estep": 2 * n_, "scatter_rows": 2 * scatters_of(p12_local(m_))}),
            ("CTPF CiteULike", lambda: tt.CTPF(tt.load_packed(os.path.join(tmp, "citeu")),
                                               100, seed=7), {}, 1,
             lambda m_, n_: {"ctpf_estep": 2 * n_,
                             "scatter_rows": 2 * scatters_of(p12_local(m_), True)}),
            ("CTM NSF V, 8,192 documents", lambda: tt.CTM(mpk, 50, seed=7), {}, 1,
             lambda m_, n_: {"lda_elbo_tok": 3 * n_,
                             "scatter_rows": 2 * scatters_of(p12_local(m_))}),
            ("fCTM NSF V, 8,192 documents", lambda: tt.fCTM(mpk, 50, seed=7), {}, 1,
             lambda m_, n_: {"scatter_rows": 2 * scatters_of(p12_local(m_))}),
            ("HMTM NSF unit counts, 16,384 documents",
             lambda: tt.HMTM(unit_counts(fpk), 25, seed=7), {}, 1,
             lambda m_, n_: {"hmtm_estep": 2 * n_, "hmtm_logz": 3 * n_,
                             "scatter_rows": 2 * scatters_of(p12_local(m_))}),
            ("DTM mac V, T=12, 8,192 documents",
             lambda: tt.DTM(mac_corpus(M=8192), 20, delta=1.0, seed=7), dict(cgiter=10), 0,
             lambda m_, n_: {"scatter_rows": 4 * n_}))
        for label, make, kw, mono, expect in cases:
            t0 = time.perf_counter()
            fm = make()
            build_s = time.perf_counter() - t0
            need(fm._n_shards == world, f"{tag} {label}: not sharded")
            n_ch = (fm.local_packed.M_pad // fm.chunk_docs if fm.local_packed.segments is None
                    else n_chunks_of(p12_local(fm)))
            t0 = time.perf_counter()
            got = run(lambda: fm.train(iter=2, checkelbo=1, printelbo=False, **kw))
            wall = time.perf_counter() - t0
            deltas = [r.delta_elbo for r in fm.trainer.trace]
            need(len(deltas) == 2 and all(d > 0 for d in deltas[mono:]),
                 f"{tag} {label}: ∆elbo {deltas}")
            want = expect(fm, n_ch)
            need(got == want, f"{tag} {label}: launches {got}, want {want}")
            fam = label.split()[0]
            keep(fam, fm)
            info.setdefault("families", []).append(fam)
            lines.append(f"{tag} {label} K={fm.K}: {n_ch} chunks; ∆elbo "
                         f"{', '.join(f'{d:.3f}' for d in deltas)}; launches {got}; built in "
                         f"{build_s:.2f} s, 2 iterations in {wall:.2f} s")
            del fm
    info["lines"] = lines
    np.savez(os.path.join(tmp, f"{mode}{rank}.npz"), **arrays)
    with open(os.path.join(tmp, f"{mode}{rank}.json"), "w") as f:
        json.dump(info, f)
    return 0


def parallel_phase(smi, kc) -> dict:
    """Phase 12, the data axis across processes: two ranks over gloo
    sharing the card, then one rank over NCCL (``parallel_child``); here
    the checks across ranks and against one process from the same init.
    Returns the ranks' launches."""
    import socket

    import numpy as np
    import torch

    import topicmodelsvb_jl_torch as tt

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="tmvb_p12_")
    spk = tt.synth_packed_nsf_scale(chunk_docs=8192)
    tt.save_packed(os.path.join(tmp, "nsf"), spk)
    tt.save_packed(os.path.join(tmp, "citeu"), kc["cpk"])

    def spawn(mode, world):
        with socket.socket() as sk:
            sk.bind(("localhost", 0))
            port = sk.getsockname()[1]
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--p12", mode,
                                   str(r), str(world), str(port), tmp],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                                  cwd=ROOT) for r in range(world)]
        try:
            outs = [p.communicate(timeout=600)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        wall = time.perf_counter() - t0
        for r, (p, out) in enumerate(zip(procs, outs)):
            if p.returncode != 0:
                print(out[-6000:])
            need(p.returncode == 0, f"phase 12: {mode} rank {r} exited {p.returncode}")
        res = []
        for r in range(world):
            with open(os.path.join(tmp, f"{mode}{r}.json")) as f:
                info = json.load(f)
            info["arrays"] = dict(np.load(os.path.join(tmp, f"{mode}{r}.npz")))
            for line in info["lines"]:
                print(f"{line}; card {smi}")
            res.append(info)
        print(f"phase 12 {mode}: {world} process(es) in {wall:.1f} s; card {smi}")
        return res

    g = spawn("gloo", 2)
    spawn("nccl", 1)
    g0, g1 = g
    # the ranks agree bit for bit on every global and on the bound
    for key in sorted(g0["arrays"]):
        need(np.array_equal(g0["arrays"][key], g1["arrays"][key]),
             f"phase 12: ranks differ on {key}")
    for key in [k for k in g0 if k.endswith("/trace")]:
        need(g0[key] == g1[key], f"phase 12: ranks' {key} differ")

    # against one process from the same init
    def against(label, got, want, got_trace, want_trace):
        err_b = float(np.linalg.norm(got["beta"] - want["beta"]) / np.linalg.norm(want["beta"]))
        need(np.allclose(got["beta"], want["beta"], rtol=RTOL, atol=ATOL),
             f"{label}: beta beyond rtol {RTOL} / atol {ATOL}")
        if "alpha" in want:
            need(np.allclose(got["alpha"], want["alpha"], rtol=RTOL, atol=ATOL),
                 f"{label}: alpha beyond rtol {RTOL} / atol {ATOL}")
        rel = [abs(a - b) / abs(b) for a, b in zip(got_trace, want_trace)]
        need(len(got_trace) == len(want_trace) and max(rel) <= 1e-5,
             f"{label}: bound per iteration {rel}")
        d_el = (float(np.max(np.abs(got["alpha"] - want["alpha"]))) if "alpha" in want
                else float("nan"))
        print(f"{label}: beta relative norm of the difference {err_b:.3e}, max abs "
              f"{float(np.max(np.abs(got['beta'] - want['beta']))):.3e}; alpha max abs "
              f"{d_el:.3e}; bound relative per iteration {', '.join(f'{x:.2e}' for x in rel)}; "
              f"card {smi}")

    a = g0["arrays"]
    one = tt.LDA(spk, 100, seed=7)
    one.train(iter=3, checkelbo=1, printelbo=False)
    against("phase 12 LDA two ranks vs one process",
            {"beta": a["lda/beta"], "alpha": a["lda/alpha"]},
            {"beta": one.beta, "alpha": one.alpha}, g0["lda/trace"],
            [r.elbo for r in one.trainer.trace])
    t0 = time.perf_counter()
    back = tt.load_checkpoint(os.path.join(tmp, "ckpt"), spk)
    load_s = time.perf_counter() - t0
    need(back.trained_iters == 3 and back._n_shards == 1, "phase 12: checkpoint load")
    back.train(iter=1, checkelbo=1, printelbo=False)
    against("phase 12 LDA two-rank checkpoint resumed in one process vs resumed on two ranks",
            {"beta": back.beta, "alpha": back.alpha},
            {"beta": a["lda_resumed/beta"], "alpha": a["lda_resumed/alpha"]},
            [r.elbo for r in back.trainer.trace], g0["lda_resumed/trace"])
    del one, back
    st1 = tt.StreamingLDA(spk, 100, chunk_docs=1024, seed=7)
    st1.train(iter=2, checkelbo=1, printelbo=False)
    sback = tt.load_streaming_checkpoint(os.path.join(tmp, "sckpt"), spk)
    need(sback._nproc == 1 and sback.trained_iters == 2, "phase 12: streaming load")
    against("phase 12 StreamingLDA two-rank checkpoint of iteration 2 loaded in one process "
            "vs one process", {"beta": sback.beta.cpu().numpy(), "alpha": sback.alpha.cpu().numpy()},
            {"beta": st1.beta.cpu().numpy(), "alpha": st1.alpha.cpu().numpy()},
            [t[1] for t in sback.trace], [t[1] for t in st1.trace])
    st1.train(iter=1, checkelbo=1, printelbo=False)
    against("phase 12 StreamingLDA two ranks vs one process, 3 iterations",
            {"beta": a["stream/beta"], "alpha": a["stream/alpha"]},
            {"beta": st1.beta.cpu().numpy(), "alpha": st1.alpha.cpu().numpy()},
            g0["stream/trace"], [t[1] for t in st1.trace])
    del st1, sback
    torch.cuda.empty_cache()
    launches = {}
    for info in g:
        for n, v in info["launches"].items():
            launches[n] = launches.get(n, 0) + v
    for r, info in enumerate(g):
        c = info["lda_coll"]
        print(f"phase 12 rank {r}: LDA step alone {info['lda_step_s']:.4f} s, collectives "
              f"{c['seconds']:.4f} s of it over {c['routes']}; launches {info['launches']}; "
              f"card {smi}")
    print(f"phase 12: checkpoint directory loaded in one process in {load_s:.2f} s; "
          f"families on two ranks: {g0['families']}; wall {time.perf_counter() - t_phase:.1f} s; "
          f"launches {launches}; card {smi}")
    shutil.rmtree(tmp, ignore_errors=True)
    return launches


P13_RANKS = 2
P13_V = 25_320   # NSF's V = 25,319 does not split into two vocab blocks: one term wider
# phase 15's cases, run by phase 13's ranks: label, family, corpus (p13_nsf
# cut to 16,384 or 8,192 documents, or p13_citeu), K, chunk
P15_CASES = (("fLDA seq, NSF V, 16,384 documents", "fLDA", "fpk", 100, 1024),
             ("CTM seq, NSF V, 8,192 documents", "CTM", "mpk", 50, 2048),
             ("fCTM seq, NSF V, 8,192 documents", "fCTM", "mpk", 50, 2048),
             ("CTPF seq, CiteULike", "CTPF", "cpk", 100, 1024))
# phase 17's float64 cases on phase 13's two ranks: label, mesh (dv: data x
# vocab, ds: data x seq), family, corpus (p13_nsf cut to 8,192 documents,
# routed over 2 vocab blocks or not, or p13_citeu), the axis keywords
P17_RANK_CASES = (
    ("LDA routed float64, NSF V, 8,192 documents", "dv", "LDA", "mrouted",
     dict(doc=("data",), vocab="vocab", routed=True)),
    ("LDA seq float64, NSF V, 8,192 documents", "ds", "LDA", "mpk",
     dict(doc=("data",), seq="seq")),
    ("fLDA seq float64, NSF V, 8,192 documents", "ds", "fLDA", "mpk",
     dict(doc=("data",), seq="seq")),
    ("CTPF seq float64, CiteULike", "ds", "CTPF", "cpk", dict(doc=("data",), seq="seq")))


def p13_nsf(M: int):
    """The dense NSF-scale corpus cut to ``M`` documents at V = P13_V
    (phases 13 and 15: the widths are NSF's, the depth is cut)."""
    import topicmodelsvb_jl_torch as tt

    return tt.synth_packed_nsf_scale(M=M, V=P13_V, chunk_docs=M // 2)


def p13_citeu(cpk):
    """The dense CiteULike corpus of phases 13 and 15: all 16,980 documents,
    padded to 18 chunks of 1024, and one (empty) user more, since U =
    5,551 does not split into two user blocks."""
    return pad_rows(dataclasses.replace(cpk, U=cpk.U + 1), 18 * 1024)


def pass_counters() -> dict:
    """The pass modes' wrappers by name (each counts its launches)."""
    from topicmodelsvb_jl_torch.kernels import ctpf_estep, flda_estep, lda_estep

    return {"lda_estep_pass": lda_estep.lda_estep_pass,
            "flda_estep_pass": flda_estep.flda_estep_pass,
            "ctpf_estep_pass": ctpf_estep.ctpf_estep_pass}


def compare_pass(tok, Vs, K, dev, label):
    """The LDA E-step's pass mode against its plain version on a chunk of
    this rank's token slots (``tok``: terms with ids below ``Vs``, counts,
    doc_mask) and a [Vs, K] table, with its times and bound."""
    import torch

    from topicmodelsvb_jl_torch.kernels.lda_estep import lda_estep_pass, lda_estep_pass_ref
    from topicmodelsvb_jl_torch.utils.numerics import EPSILON, dirichlet_ones

    terms, counts, doc_mask = tok
    B, L = terms.shape
    betaT = (dirichlet_ones(torch.Generator().manual_seed(13), Vs, (K,)).to(dev)
             + EPSILON).T.contiguous()
    _, _, El, _ = warm_state(K, B, dev, seed=14)
    args = (betaT, terms, counts, doc_mask, El)
    got, want = lda_estep_pass(*args), lda_estep_pass_ref(*args)
    torch.cuda.synchronize()
    err = close((got,), (want,), ("pc",), f"lda_estep_pass {label}")
    need(torch.equal(got, lda_estep_pass(*args)), f"lda_estep_pass {label}: not bitwise repeatable")
    need(bool(torch.all(got[doc_mask == 0] == 0)), f"lda_estep_pass {label}: padded pc")
    keep = counts > 0
    kept, uniq = int(keep.sum()), n_unique(terms, keep)
    # table rows, terms and counts, doc_mask, El in and pc out; 4 K flops a
    # kept slot (its s and its share of q) and K exps a document
    rec = record(err, time_calls(lambda: lda_estep_pass(*args), N_KERNEL),
                 time_calls(lambda: lda_estep_pass_ref(*args), N_PLAIN, reps=1),
                 bound_ms(4 * (uniq * K + 2 * B * L + B + 2 * B * K), 4 * K * kept + B * K))
    print(f"lda_estep_pass {label}: B={B} L={L} K={K} Vs={Vs} kept={kept} | {times(rec)}")
    return rec


def p13_case(tag, mesh, fam, packed, K, iters, kern, doc, vocab=None, user=None, seq=None,
             routed=False, slice_id=None, T=None, chunk=1024, step_kw=None, time_step=False,
             dtype="float32"):
    """One family's make_step/make_elbo on this rank's slab of ``packed``
    over ``mesh`` from the family's init (seed 7, drawn whole and cut by
    ``convert.shard_state``) in ``dtype``, ``iters`` iterations, the launch
    counts set to 0 before and read after (a float64 mode's launches also
    under ``<kernel>_double``).  Returns (launches, bounds from the init
    on, the globals gathered whole, the step timed alone or None)."""
    import numpy as np
    import torch

    from topicmodelsvb_jl_torch import convert
    from topicmodelsvb_jl_torch.models import ctm, ctpf, dtm, fctm, flda, hmtm, lda
    from topicmodelsvb_jl_torch.parallel import shard
    from topicmodelsvb_jl_torch.parallel.mesh import local_block
    from topicmodelsvb_jl_torch.parallel.multihost import local_slab
    from topicmodelsvb_jl_torch.utils.numerics import elbo_value

    dev = torch.device("cuda", torch.cuda.current_device())
    mod = {"LDA": lda, "fLDA": flda, "CTM": ctm, "fCTM": fctm, "CTPF": ctpf, "DTM": dtm,
           "HMTM": hmtm}[fam]
    cls = {"LDA": lda.LDAState, "fLDA": flda.FLDAState, "CTM": ctm.CTMState,
           "fCTM": fctm.FCTMState, "CTPF": ctpf.CTPFState, "DTM": dtm.DTMState,
           "HMTM": hmtm.HMTMState}[fam]
    gen = torch.Generator().manual_seed(7)
    whole = (mod.init(gen, packed, K, T) if fam == "DTM" else mod.init(gen, packed, K))
    dt = getattr(torch, dtype)
    state = convert.shard_state(cls, {f: getattr(whole, f).numpy() for f in
                                      cls.__dataclass_fields__}, mesh, data_axis=doc,
                                vocab_axis=vocab, user_axis=user, seq_axis=seq, device=dev,
                                dtype=dt)
    del whole
    slab = local_slab(packed, mesh, doc, vocab if routed else seq)
    put = lambda a, dt: torch.as_tensor(np.array(a), dtype=dt).to(dev)
    t, c, dm = (put(slab.terms, torch.int32), put(slab.counts, dt), put(slab.doc_mask, dt))
    tol = 1.0 / K ** 2
    common = dict(viter=10, vtol=tol, niter=1000, ntol=tol, chunk_docs=chunk, device=dev)
    kw = dict(mesh=mesh, axis_name=doc, vocab_axis=vocab)
    if seq is not None:
        kw.update(seq_axis=seq)
    M = float(packed.M)
    if fam == "LDA":
        kw.update(vocab_routed=routed)
        args, eargs = (t, c, dm, M), (t, c, dm)
    elif fam == "fLDA":
        args, eargs = (t, c, dm, torch.tensor(M, dtype=dt, device=dev),
                       torch.tensor(float(packed.C.sum()), dtype=dt, device=dev)), (t, c, dm)
    elif fam == "CTPF":
        kw.update(user_axis=user)
        common = dict(viter=10, vtol=tol, chunk_docs=chunk, device=dev)
        args = eargs = (t, c, put(slab.readers, torch.int32), put(slab.ratings, dt), dm)
    elif fam == "DTM":
        rows = local_block(slice_id, mesh, doc)
        common.update(cgiter=10, cgtol=1.0 / T ** 2, slice_id=rows)
        args = eargs = (put(rows, torch.int64), t, c, dm)
    else:
        args, eargs = (t, c, dm, M), (t, c, dm)
    step = (mod.make_step(slab, K, T, **common, **kw) if fam == "DTM"
            else mod.make_step(slab, K, **common, **kw))
    elbo = (mod.make_elbo(slab, K, T, chunk, **kw) if fam == "DTM"
            else mod.make_elbo(slab, K, chunk, **kw))
    for k in kern.values():
        k.launches = 0
        k.launches_double = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trace = [elbo_value(elbo(state, *eargs))]
    for _ in range(iters):
        state = step(state, *args)
        trace.append(elbo_value(elbo(state, *eargs)))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = {n: k.launches for n, k in kern.items() if k.launches}
    got.update({f"{n}_double": k.launches_double for n, k in kern.items() if k.launches_double})
    alone = None
    if time_step:   # one more step alone, its collectives timed
        shard.STATS.reset()
        shard.STATS.timed = True
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(state, *args)
        torch.cuda.synchronize()
        alone = dict(step_s=time.perf_counter() - t0, calls=shard.STATS.calls,
                     bytes=shard.STATS.bytes, seconds=shard.STATS.seconds,
                     routes=dict(shard.STATS.routes))
        shard.STATS.timed = False
    lay = convert.LAYOUT[cls]
    glob = {}
    for f in cls.__dataclass_fields__:
        if f in lay["doc"]:
            continue
        x = getattr(state, f)
        for key, axis in (("vocab", vocab), ("user", user)):
            if axis is not None and f in lay.get(key, {}):
                x = shard.all_gather(x, mesh, axis, dim=lay[key][f])
        glob[f] = x.cpu().numpy()
    need(all(np.isfinite(v).all() for v in glob.values()) and np.isfinite(trace).all(),
         f"{tag} {fam}: a global or the bound is not finite")
    return got, trace, glob, alone, wall


def tp_child(rank: int, world: int, port: int, tmp: str) -> int:
    """One process of phase 13 (``chip_smoke.py --p13 RANK WORLD PORT
    DIR``): a rank of a gloo group of two sharing the card.  Writes
    ``DIR/tp{rank}.npz`` (every case's globals, gathered whole) and
    ``.json`` (launches, bounds, times, printed lines); any failed check
    exits non-zero."""
    import numpy as np
    import torch

    from topicmodelsvb_jl_torch.parallel import multihost, shard

    multihost.initialize(f"localhost:{port}", world, rank, backend="gloo")
    import topicmodelsvb_jl_torch as tt
    from topicmodelsvb_jl_torch.ops.packing import unit_counts
    from topicmodelsvb_jl_torch.parallel.mesh import make_mesh
    from topicmodelsvb_jl_torch.streaming import slices_from_stamps

    kern = dict(p12_counters(), **pass_counters())
    tag = f"[tp rank {rank}/{world}]"
    dv = make_mesh(axis_names=("data", "vocab"), shape=(1, 2))
    ds = make_mesh(axis_names=("data", "seq"), shape=(1, 2))
    dvu = {s: make_mesh(axis_names=("data", "vocab", "user"), shape=s)
           for s in ((1, 2, 1), (1, 1, 2))}
    arrays, info, lines = {}, {"launches": {}, "alone": {}}, []
    spk = tt.load_packed(os.path.join(tmp, "nsf"))
    routed = tt.route_packed(spk, n_shards=2)
    fpk, mpk = p13_nsf(16_384), p13_nsf(8192)
    cpk = tt.load_packed(os.path.join(tmp, "citeu"))
    mac = mac_corpus(M=8192, V=15_114)
    dpk = tt.pack_corpus(mac, pad_multiple=8, docs_multiple=2048)
    T, sid = slices_from_stamps(np.array([d.stamp for d in mac.docs]), 1.0, dpk.M_pad)
    dvv = dict(doc=("data", "vocab"), vocab="vocab")
    cases = (   # label, mesh, family, corpus, K, iterations, mono, keywords
        ("LDA storage TP", dv, "LDA", spk, 100, 3, 0, dict(time_step=True, **dvv)),
        # no document split: every rank runs all 128 chunks, a collective a
        # pass (~7 s a step on one card), so two iterations
        ("LDA routed", dv, "LDA", routed, 100, 2, 0,
         dict(doc=("data",), vocab="vocab", routed=True, time_step=True)),
        ("LDA seq", ds, "LDA", spk, 100, 2, 0, dict(doc=("data",), seq="seq", time_step=True)),
        ("fLDA NSF V, 16,384 documents", dv, "fLDA", fpk, 100, 2, 1, dvv),
        ("CTM NSF V, 8,192 documents", dv, "CTM", mpk, 50, 2, 1, dict(chunk=2048, **dvv)),
        ("fCTM NSF V, 8,192 documents", dv, "fCTM", mpk, 50, 2, 1, dict(chunk=2048, **dvv)),
        ("HMTM NSF unit counts, 16,384 documents", dv, "HMTM", unit_counts(fpk), 25, 2, 1,
         dvv),
        ("DTM mac V+1, T=12, 8,192 documents", dv, "DTM", dpk, 20, 2, 0,
         dict(slice_id=sid, T=T, **dvv)),
        ("CTPF CiteULike, vocab axis", dvu[(1, 2, 1)], "CTPF", cpk, 100, 2, 1,
         dict(doc=("data", "vocab", "user"), vocab="vocab", user="user")),
        ("CTPF CiteULike, user axis", dvu[(1, 1, 2)], "CTPF", cpk, 100, 2, 1,
         dict(doc=("data", "vocab", "user"), vocab="vocab", user="user")))
    # phase 15: the sequence axis of fLDA, CTM, fCTM and CTPF, here so the
    # corpora load once; phase 15 holds them against one process
    corpora = dict(fpk=fpk, mpk=mpk, cpk=cpk)
    cases += tuple((label, ds, fam, corpora[key], K, 2, 1,
                    dict(doc=("data",), seq="seq", chunk=chunk, time_step=True))
                   for label, fam, key, K, chunk in P15_CASES)
    # phase 17: the token-splitting axes in float64, at a cut depth (8,192
    # documents of the NSF widths; CiteULike whole); phase 17 holds them
    # against one float64 process
    mrouted = tt.route_packed(mpk, n_shards=2)
    for label, mesh, fam, key, kw in P17_RANK_CASES:
        pk = {"mrouted": mrouted, "mpk": mpk, "cpk": cpk}[key]
        cases += ((label, {"dv": dv, "ds": ds}[mesh], fam, pk, 100, 2, int(fam != "LDA"),
                   dict(kw, dtype="float64")),)
    for label, mesh, fam, pk, K, iters, mono, kw in cases:
        got, trace, glob, alone, wall = p13_case(tag, mesh, fam, pk, K, iters, kern, **kw)
        deltas = np.diff(trace).tolist()
        need(all(d > 0 for d in deltas[mono:]), f"{tag} {label}: ∆elbo {deltas}")
        path = {"LDA": ("lda_estep", "lda_elbo_tok", "scatter_rows"),
                "fLDA": ("flda_estep", "scatter_rows"), "CTM": ("lda_elbo_tok", "scatter_rows"),
                "fCTM": ("scatter_rows",), "HMTM": ("hmtm_estep", "hmtm_logz", "scatter_rows"),
                "DTM": ("scatter_rows",), "CTPF": ("ctpf_estep", "scatter_rows")}[fam]
        if kw.get("routed") or kw.get("seq"):
            path += {"LDA": ("lda_estep_pass",), "fLDA": ("flda_estep_pass",),
                     "CTPF": ("ctpf_estep_pass",)}.get(fam, ())
        need(all(got.get(n, 0) > 0 for n in path), f"{tag} {label}: launches {got}, path {path}")
        if kw.get("dtype") == "float64":
            need(all(got.get(f"{n}_double", 0) > 0 for n in path),
                 f"{tag} {label}: float64 launches {got}, path {path}")
        for n, v in got.items():
            info["launches"][n] = info["launches"].get(n, 0) + v
        for f, v in glob.items():
            arrays[f"{label}/{f}"] = v
        info[f"{label}/trace"] = trace
        line = (f"{tag} {label} K={K}: ∆elbo {', '.join(f'{d:.3f}' for d in deltas)}; "
                f"launches {got}; {iters} iterations with their bounds in {wall:.2f} s")
        if alone is not None:
            info["alone"][label] = alone
            line += (f"; one step alone {alone['step_s']:.4f} s, of which collectives "
                     f"{alone['seconds']:.4f} s ({alone['calls']} calls, "
                     f"{alone['bytes'] / 2**20:.1f} MiB sent, routes {alone['routes']})")
        lines.append(line)
    # StreamingLDA with beta's storage over the vocab axis
    for k in kern.values():
        k.launches = 0
    t0 = time.perf_counter()
    sm = tt.StreamingLDA(spk, 100, chunk_docs=1024, seed=7, mesh=dv, vocab_axis="vocab")
    need(sm._nproc == world and sm.beta.shape == (100, P13_V // 2), f"{tag} StreamingLDA beta")
    sm.train(iter=2, checkelbo=1, printelbo=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = {n: k.launches for n, k in kern.items() if k.launches}
    deltas = [x[2] for x in sm.trace]
    need(len(deltas) == 2 and all(d > 0 for d in deltas), f"{tag} StreamingLDA ∆elbo {deltas}")
    need(all(got.get(n, 0) > 0 for n in ("lda_estep", "lda_elbo_tok", "scatter_rows")),
         f"{tag} StreamingLDA launches {got}")
    for n, v in got.items():
        info["launches"][n] = info["launches"].get(n, 0) + v
    arrays["StreamingLDA/beta"] = shard.all_gather(sm.beta, dv, "vocab", dim=1).cpu().numpy()
    arrays["StreamingLDA/alpha"] = sm.alpha.cpu().numpy()
    info["StreamingLDA/trace"] = [x[1] for x in sm.trace]
    lines.append(f"{tag} StreamingLDA NSF V+1 K=100, vocab axis: {sm.M_rows} of {spk.M_pad} "
                 f"rows; ∆elbo {', '.join(f'{d:.3f}' for d in deltas)}; launches {got}; "
                 f"2 iterations in {wall:.2f} s")
    info["lines"] = lines
    np.savez(os.path.join(tmp, f"tp{rank}.npz"), **arrays)
    with open(os.path.join(tmp, f"tp{rank}.json"), "w") as f:
        json.dump(info, f)
    return 0


def tp_phase(smi, kc) -> tuple:
    """Phase 13, tensor and sequence parallelism: the pass mode against
    its plain version here, then two gloo ranks sharing the card
    (``tp_child``); here the checks across ranks and LDA's three modes
    against one process from the same init.  Returns (the ranks'
    launches, the pass mode's record)."""
    import socket

    import numpy as np
    import torch

    import topicmodelsvb_jl_torch as tt
    from topicmodelsvb_jl_torch.models import lda

    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    tmp = tempfile.mkdtemp(prefix="tmvb_p13_")
    spk = tt.synth_packed_nsf_scale(V=P13_V, chunk_docs=8192)
    tt.save_packed(os.path.join(tmp, "nsf"), spk)
    tt.save_packed(os.path.join(tmp, "citeu"), p13_citeu(kc["cpk"]))

    # the pass mode on its main path's chunks: the first 1024 documents'
    # slots of vocab block 0 (routed) and of the first half of the token
    # axis (seq), K = 100
    routed = tt.route_packed(spk, n_shards=2)
    put = lambda a, dt: torch.as_tensor(np.ascontiguousarray(a), dtype=dt).to(dev)
    f32, i32 = torch.float32, torch.int32
    rec = compare_pass((put(routed.terms[:1024, :routed.Ls], i32),
                        put(routed.counts[:1024, :routed.Ls], f32),
                        put(routed.doc_mask[:1024], f32)), routed.Vs, 100, dev,
                       f"routed, vocab block 0 of 2, Ls={routed.Ls}")
    h = spk.L // 2
    rec_seq = compare_pass((put(spk.terms[:1024, :h], i32), put(spk.counts[:1024, :h], f32),
                            put(spk.doc_mask[:1024], f32)), spk.V, 100, dev,
                           f"seq, token half 0 of 2, L={h}")
    rec["max_abs_err"] = max(rec["max_abs_err"], rec_seq["max_abs_err"])
    del routed

    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--p13", str(r),
                               str(P13_RANKS), str(port), tmp],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              cwd=ROOT) for r in range(P13_RANKS)]
    try:
        outs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    wall = time.perf_counter() - t0
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            print(out[-6000:])
        need(p.returncode == 0, f"phase 13: rank {r} exited {p.returncode}")
    res = []
    for r in range(P13_RANKS):
        with open(os.path.join(tmp, f"tp{r}.json")) as f:
            info = json.load(f)
        info["arrays"] = dict(np.load(os.path.join(tmp, f"tp{r}.npz")))
        for line in info["lines"]:
            print(f"{line}; card {smi}")
        res.append(info)
    print(f"phase 13: {P13_RANKS} processes in {wall:.1f} s; card {smi}")
    g0, g1 = res
    for key in sorted(g0["arrays"]):
        need(np.array_equal(g0["arrays"][key], g1["arrays"][key]),
             f"phase 13: ranks differ on {key}")
    for key in [k for k in g0 if k.endswith("/trace")]:
        need(g0[key] == g1[key], f"phase 13: ranks' {key} differ")

    # LDA's three modes against one process with no mesh, from one init
    gen = torch.Generator().manual_seed(7)
    state = lda.init(gen, spk, 100, device=dev)
    tol = 1.0 / 100 ** 2
    step = lda.make_step(spk, 100, viter=10, vtol=tol, niter=1000, ntol=tol, chunk_docs=1024,
                         device=dev)
    elbo = lda.make_elbo(spk, 100, 1024)
    data = (put(spk.terms, i32), put(spk.counts, f32), put(spk.doc_mask, f32))
    from topicmodelsvb_jl_torch.utils.numerics import elbo_value

    trace, ref = [elbo_value(elbo(state, *data))], []
    for _ in range(3):
        state = step(state, *data, float(spk.M))
        trace.append(elbo_value(elbo(state, *data)))
        ref.append((state.beta.cpu().numpy(), state.alpha.cpu().numpy()))
    for label in ("LDA storage TP", "LDA routed", "LDA seq"):
        a = g0["arrays"]
        got_b, got_a = a[f"{label}/beta"], a[f"{label}/alpha"]
        n = len(g0[f"{label}/trace"])
        beta, alpha = ref[n - 2]
        need(np.allclose(got_b, beta, rtol=RTOL, atol=ATOL),
             f"phase 13 {label}: beta beyond rtol {RTOL} / atol {ATOL}")
        need(np.allclose(got_a, alpha, rtol=RTOL, atol=ATOL),
             f"phase 13 {label}: alpha beyond rtol {RTOL} / atol {ATOL}")
        rel = [abs(x - y) / abs(y) for x, y in zip(g0[f"{label}/trace"], trace)]
        need(n >= 3 and max(rel) <= 1e-5, f"phase 13 {label}: bound per iteration {rel}")
        print(f"phase 13 {label} on two ranks vs one process, {n - 1} iterations: beta max abs "
              f"{float(np.max(np.abs(got_b - beta))):.3e}, relative norm "
              f"{float(np.linalg.norm(got_b - beta) / np.linalg.norm(beta)):.3e}; alpha max abs "
              f"{float(np.max(np.abs(got_a - alpha))):.3e}; bound relative from the init on "
              f"{', '.join(f'{x:.2e}' for x in rel)}; card {smi}")
    del state, data
    torch.cuda.empty_cache()
    launches = {}
    for info in res:
        for n, v in info["launches"].items():
            launches[n] = launches.get(n, 0) + v
    for r, info in enumerate(res):
        for label, c in info["alone"].items():
            print(f"phase 13 rank {r} {label}: one step alone {c['step_s']:.4f} s, collectives "
                  f"{c['seconds']:.4f} s, {c['calls']} calls, {c['bytes']} bytes sent; card {smi}")
    print(f"phase 13: lda_estep_pass {rec['ms'] * 1e3:.1f} us device, "
          f"{rec['call_ms'] * 1e3:.1f} us a call, bound {rec['bound_ms'] * 1e3:.1f} us by "
          f"{rec['bound_by']}, plain {rec['plain_ms'] * 1e3:.1f} us, launches on the ranks "
          f"{launches.get('lda_estep_pass', 0)}; wall {time.perf_counter() - t_phase:.1f} s; "
          f"launches {launches}; card {smi}")
    shutil.rmtree(tmp, ignore_errors=True)
    return launches, rec, res



def compare_flda_pass(seg, V, K, dev, label):
    """Phase 15: the fLDA E-step's pass mode against its plain version on
    one rank's share of a chunk's token slots (``seg``), with phase 3's
    arguments (``flda_args``): within RTOL/ATOL, bitwise repeatable, pc 0
    and tau kept on masked documents; its times and bound.  Then
    ``flda_estep`` at ``viter = 0``, the split fixpoint's last call: the
    state as given, bit for bit, and w against its plain version."""
    import torch

    from topicmodelsvb_jl_torch.kernels.flda_estep import (
        flda_estep, flda_estep_pass, flda_estep_pass_ref, flda_estep_ref,
    )

    terms, counts, doc_mask = seg
    B, L = terms.shape
    args = flda_args(seg, V, K, dev)
    logbetaT, kappa, _, _, _, _, eta, _, El, _, tau, _ = args
    pargs = (logbetaT, kappa, terms, counts, doc_mask, eta, El, tau)
    got, want = flda_estep_pass(*pargs), flda_estep_pass_ref(*pargs)
    torch.cuda.synchronize()
    err = close(got, want, ("pc", "tau_new"), f"flda_estep_pass {label}")
    need(all(torch.equal(a, b) for a, b in zip(got, flda_estep_pass(*pargs))),
         f"flda_estep_pass {label}: not bitwise repeatable")
    pad = doc_mask == 0
    need(bool(torch.all(got[0][pad] == 0)) and torch.equal(got[1][pad], tau[pad]),
         f"flda_estep_pass {label}: a masked document moved")
    kw0 = dict(viter=0, vtol=1.0 / K**2)
    z = flda_estep(*args, **kw0)
    need(all(torch.equal(a, b) for a, b in zip(z[:5], args[7:])),
         f"flda_estep viter=0 {label}: the state moved")
    err0 = close(z[5:], flda_estep_ref(*args, **kw0)[5:], ("w",), f"flda_estep viter=0 {label}")
    keep = counts > 0
    kept = int(keep.sum())
    live = (doc_mask > 0)[:, None].expand(B, L)
    slots = int(live.sum())   # every slot of a real document takes K exps, padding too
    # table rows and kappa of the distinct ids; terms, counts and tau in;
    # doc_mask, eta, El in; pc and tau_new out.  4 K flops a slot of a real
    # document (the exponent, s, Σ p·log beta) and 2 K a kept slot (pc)
    rec = record(err, time_calls(lambda: flda_estep_pass(*pargs), N_KERNEL),
                 time_calls(lambda: flda_estep_pass_ref(*pargs), N_PLAIN, reps=1),
                 bound_ms(4 * (n_unique(terms, live) * (K + 1) + 3 * B * L + B + 1 + B * K
                               + B * K + B * L), 4 * K * slots + 2 * K * kept))
    rec["exp_floor_ms"] = K * slots / EX2_PER_S * 1e3
    print(f"flda_estep_pass {label}: B={B} L={L} K={K} kept={kept} | {times(rec)}; exp floor "
          f"{rec['exp_floor_ms']:.4f} ms | flda_estep viter=0: state kept, w max abs err "
          f"{err0:.3e}")
    return rec, {"max_abs_err": err0}


def compare_ctpf_pass(tok, rd, V, U, K, dev, label):
    """Phase 15: the CTPF E-step's pass mode against its plain version on
    one rank's share of a chunk's token and reader slots, with phase 3's
    arguments (``ctpf_args``): within RTOL/ATOL, bitwise repeatable, zeros
    on masked documents; its times and bound.  Then ``ctpf_estep`` at
    ``viter = 0``: the state as given and wa/wh against the plain
    version."""
    import torch

    from topicmodelsvb_jl_torch.kernels.ctpf_estep import (
        ctpf_estep, ctpf_estep_pass, ctpf_estep_pass_ref, ctpf_estep_ref,
    )

    terms, counts, doc_mask = tok
    readers, ratings = rd
    B, L = terms.shape
    R = readers.shape[1]
    args, kw = ctpf_args(tok, rd, V, U, K, dev)
    pargs = (*args[:10], args[10], args[12])
    got, want = ctpf_estep_pass(*pargs), ctpf_estep_pass_ref(*pargs)
    torch.cuda.synchronize()
    err = close(got, want, ("gsum", "zsum"), f"ctpf_estep_pass {label}")
    need(all(torch.equal(a, b) for a, b in zip(got, ctpf_estep_pass(*pargs))),
         f"ctpf_estep_pass {label}: not bitwise repeatable")
    pad = doc_mask == 0
    need(all(bool(torch.all(x[pad] == 0)) for x in got),
         f"ctpf_estep_pass {label}: a masked document got a statistic")
    kw0 = dict(kw, viter=0)
    z = ctpf_estep(*args, **kw0)
    need(all(torch.equal(a, b) for a, b in zip(z[:4], args[10:])),
         f"ctpf_estep viter=0 {label}: the state moved")
    err0 = close(z[4:], ctpf_estep_ref(*args, **kw0)[4:], ("wa", "wh"),
                 f"ctpf_estep viter=0 {label}")
    kt, kr = counts > 0, ratings > 0
    kept = int(kt.sum()) + int(kr.sum())
    live = int((doc_mask > 0).sum())
    # distinct table rows, the slots, doc_mask, the [K] vectors and gimel,
    # zayin in; gsum, zsum out.  4 K flops a kept slot (its normaliser and
    # its share of the product) and the [K] factors of a real document
    rec = record(err, time_calls(lambda: ctpf_estep_pass(*pargs), N_KERNEL),
                 time_calls(lambda: ctpf_estep_pass_ref(*pargs), N_PLAIN, reps=1),
                 bound_ms(4 * ((n_unique(terms, kt) + n_unique(readers, kr)) * K
                               + 2 * B * (L + R) + B + 3 * K + 4 * B * K),
                          4 * K * kept + 8 * K * live))
    print(f"ctpf_estep_pass {label}: B={B} L={L} R={R} K={K} kept={kept} | {times(rec)} | "
          f"ctpf_estep viter=0: state kept, wa/wh max abs err {err0:.3e}")
    return rec, {"max_abs_err": err0}


def seq_phase(smi, kc, dev, ranks) -> dict:
    """Phase 15, the sequence axis of fLDA, CTM, fCTM and CTPF: the pass
    modes of ``flda_estep`` and ``ctpf_estep`` and both E-steps at ``viter
    = 0`` against their plain versions; then phase 13's two ranks' runs
    of P15_CASES (``ranks``: their records, already checked bitwise equal)
    against one process with no mesh on the same corpus from the same
    init.  Returns the records for the ``kernels`` line."""
    import numpy as np
    import torch

    t_phase = time.perf_counter()
    put = lambda a, dt: torch.as_tensor(np.ascontiguousarray(a), dtype=dt).to(dev)
    f32, i32 = torch.float32, torch.int32
    fpk, mpk = p13_nsf(16_384), p13_nsf(8192)
    cpk, K = kc["cpk"], kc["K"]
    lc = long_chunks(kc["V"], cpk.U, dev)

    # the pass modes on their main paths' chunks, rank 0's half of the
    # token (and reader) slots of the first 1024 documents, and on half of
    # phase 3's chunks whose rows do not fit shared memory
    h = fpk.L // 2
    fl, fl0 = compare_flda_pass((put(fpk.terms[:1024, :h], i32), put(fpk.counts[:1024, :h], f32),
                                 put(fpk.doc_mask[:1024], f32)), fpk.V, K, dev,
                                f"seq, NSF V token half 0 of 2, L={h}")
    lt, lcn, lm = lc["long_pad"]
    half = lt.shape[1] // 2
    fl_long, fl0_long = compare_flda_pass(
        (lt[:, :half].contiguous(), lcn[:, :half].contiguous(), lm), kc["V"], K, dev,
        f"L={half} of 1024, rows in tiles")
    hl, hr = cpk.L // 2, cpk.Rmax // 2
    ct, ct0 = compare_ctpf_pass(
        (put(cpk.terms[:1024, :hl], i32), put(cpk.counts[:1024, :hl], f32),
         put(cpk.doc_mask[:1024], f32)),
        (put(cpk.readers[:1024, :hr], i32), put(cpk.ratings[:1024, :hr], f32)), cpk.V, cpk.U,
        K, dev, f"seq, CiteULike token and reader halves 0 of 2, L={hl} R={hr}")
    (ctt, ctc, ctm_), (ctr, ctq) = lc["ctpf_long"]
    ht, hq = ctt.shape[1] // 2, ctr.shape[1] // 2
    ct_long, ct0_long = compare_ctpf_pass(
        (ctt[:, :ht].contiguous(), ctc[:, :ht].contiguous(), ctm_),
        (ctr[:, :hq].contiguous(), ctq[:, :hq].contiguous()), kc["V"], cpk.U, K, dev,
        f"L={ht} R={hq} of 768 and 256, rows in tiles")
    del lc
    t_kernels = time.perf_counter() - t_phase

    # the two ranks against one process, from the same init
    corpora = dict(fpk=fpk, mpk=mpk, cpk=p13_citeu(cpk))
    kern = dict(p12_counters(), **pass_counters())
    g0 = ranks[0]
    launches = {}
    for label, fam, key, Kf, chunk in P15_CASES:
        got, trace, glob, _, wall = p13_case("[phase 15, one process]", None, fam, corpora[key],
                                             Kf, 2, kern, doc=("data",), chunk=chunk)
        for n, v in got.items():
            launches[n] = launches.get(n, 0) + v
        a, worst = g0["arrays"], {}
        for f, want in glob.items():
            if f == "elbo":
                continue
            have = a[f"{label}/{f}"]
            need(np.allclose(have, want, rtol=RTOL, atol=ATOL),
                 f"phase 15 {label}: {f} beyond rtol {RTOL} / atol {ATOL} of one process")
            worst[f] = float(np.max(np.abs(have - want)))
        ranks_trace = g0[f"{label}/trace"]
        rel = [abs(x - y) / abs(y) for x, y in zip(ranks_trace, trace)]
        need(len(ranks_trace) == 3 and max(rel) <= 1e-5,
             f"phase 15 {label}: bound per iteration {rel}")
        steps = "; ".join(
            f"rank {r} one step alone {c['step_s']:.4f} s, collectives {c['seconds']:.4f} s, "
            f"{c['calls']} calls, {c['bytes'] / 2**20:.1f} MiB sent"
            for r, c in enumerate(info["alone"][label] for info in ranks))
        print(f"phase 15 {label} on two ranks (data 1 x seq 2) vs one process, 2 iterations: "
              f"max abs {', '.join(f'{f} {v:.3e}' for f, v in worst.items())}; bound relative "
              f"from the init on {', '.join(f'{x:.2e}' for x in rel)}; one process 2 "
              f"iterations with their bounds in {wall:.2f} s; {steps}; card {smi}")
    pass_launches = {n: sum(info["launches"].get(n, 0) for info in ranks)
                     for n in ("flda_estep_pass", "ctpf_estep_pass")}
    need(all(v > 0 for v in pass_launches.values()),
         f"phase 15: a pass kernel never launched on the ranks: {pass_launches}")
    print(f"phase 15: flda_estep_pass {fl['ms'] * 1e3:.1f} us device, bound "
          f"{fl['bound_ms'] * 1e3:.1f} us; ctpf_estep_pass {ct['ms'] * 1e3:.1f} us device, bound "
          f"{ct['bound_ms'] * 1e3:.1f} us; launches on the ranks {pass_launches}; kernels "
          f"{t_kernels:.1f} s, wall {time.perf_counter() - t_phase:.1f} s; card {smi}")
    torch.cuda.empty_cache()
    return dict(launches=launches, flda_pass=(fl, fl_long), ctpf_pass=(ct, ct_long),
                viter0=dict(flda_estep=(fl0, fl0_long), ctpf_estep=(ct0, ct0_long)))



def compare_f64(seg, V, K, dev, label) -> dict:
    """Phase 14: the f64 Elogtheta modes of ``lda_estep`` and ``flda_estep``
    against their plain versions (ψ in float64) on one chunk, with phase
    3's arguments: within RTOL/ATOL, bitwise repeatable, El not the f32
    mode's; times and bounds as phase 3's (the same bytes; the float64 ψ,
    K + 1 a pass a document, is below the f32 operations counted)."""
    import torch

    from topicmodelsvb_jl_torch.kernels import flda_estep as flda_mod
    from topicmodelsvb_jl_torch.kernels import lda_estep as estep_mod
    from topicmodelsvb_jl_torch.kernels.flda_estep import flda_estep, flda_estep_ref
    from topicmodelsvb_jl_torch.kernels.lda_estep import lda_estep, lda_estep_ref

    terms, counts, doc_mask = seg
    B, L = terms.shape
    keep = counts > 0
    kept, uniq = int(keep.sum()), n_unique(terms, keep)
    f32 = dict(viter=10, vtol=1.0 / K**2)
    kw = dict(f32, elogtheta_f64=True)
    cases = (
        ("lda_estep_f64", lda_estep, lda_estep_ref, estep_mod, lda_args(seg, V, K, dev)[0],
         ("gamma", "El", "El_old", "w"),
         4 * (uniq * K + 2 * B * L + B + K + 6 * B * K + B * L * K), 2 * K * kept),
        ("flda_estep_f64", flda_estep, flda_estep_ref, flda_mod, flda_args(seg, V, K, dev),
         ("gamma", "El", "El_old", "tau", "tau_old", "w"),
         4 * (uniq * (K + 1) + 4 * B * L + B + K + 1 + 6 * B * K + 2 * B * L
              + B * L * (K + 1)), 2 * (K + 1) * kept))
    out = {}
    for name, kern, ref, mod, args, names, nbytes, ops in cases:
        n0 = kern.launches_f64
        got = kern(*args, **kw)
        want = ref(*args, **kw)
        torch.cuda.synchronize()
        need(kern.launches_f64 == n0 + 1, f"{name} {label}: the f64 mode did not launch")
        err = close(got, want, names, f"{name} {label}")
        need(all(torch.equal(a, b) for a, b in zip(got, kern(*args, **kw))),
             f"{name} {label}: not bitwise repeatable")
        need(not torch.equal(got[1], kern(*args, **f32)[1]),
             f"{name} {label}: El equals the f32 mode's")
        work = fixpoint_work(mod, ref, args, kw, keep.sum(1).float())
        out[name] = record(err, time_calls(lambda: kern(*args, **kw), N_KERNEL),
                           time_calls(lambda: ref(*args, **kw), N_PLAIN, reps=1),
                           bound_ms(nbytes, 4 * K * work + ops))
        print(f"kernels {label}: B={B} L={L} K={K} | {name} {times(out[name])}")
    return out


def cli_phase(smi, kc, dev) -> tuple:
    """Phase 14, the CLI (``train.run``, as ``python -m
    topicmodelsvb_jl_torch.train`` calls it) on the card, the launch counts
    set to 0 before each run and read after: returns them and the f64
    modes' records (the widest NSF chunk, then the L = 1024 one)."""
    import socket
    import types

    import numpy as np
    import torch

    import topicmodelsvb_jl_torch as tt
    from topicmodelsvb_jl_torch import engine, train
    from topicmodelsvb_jl_torch.kernels.ctpf_estep import ctpf_estep
    from topicmodelsvb_jl_torch.kernels.flda_estep import flda_estep
    from topicmodelsvb_jl_torch.kernels.lda_elbo import lda_elbo_tok
    from topicmodelsvb_jl_torch.kernels.lda_estep import lda_estep
    from topicmodelsvb_jl_torch.kernels.scatter_rows import scatter_rows

    t_phase = time.perf_counter()
    K, V, bucketed = kc["K"], kc["V"], kc["bucketed"]
    put = lambda a, dt: torch.as_tensor(np.ascontiguousarray(a), dtype=dt).to(dev)
    s0 = bucketed.segments[0]
    wide = (put(s0.terms[:1024], torch.int32), put(s0.counts[:1024], torch.float32),
            put(s0.doc_mask[:1024], torch.float32))
    recs = [compare_f64(wide, V, K, dev, f"widest bucket L={s0.L}"),
            compare_f64(long_chunks(V, kc["cpk"].U, dev)["long_pad"], V, K, dev,
                        "L=1024 rows in device memory")]
    f64 = {name: tuple(r[name] for r in recs) for name in recs[0]}

    kerns = (lda_estep, lda_elbo_tok, flda_estep, ctpf_estep, scatter_rows)
    launches = {}
    os.makedirs(os.path.join(ROOT, "_tmp"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="p14_", dir=os.path.join(ROOT, "_tmp"))

    def cli(label, argv, metrics=True):
        """One in-process CLI run: (summary, its ∆elbo per iteration, its
        launches by kernel and mode)."""
        for k in kerns:
            k.launches = 0
        lda_estep.launches_f64 = flda_estep.launches_f64 = 0
        rows_path = os.path.join(tmp, f"{label}.jsonl")
        t0 = time.perf_counter()
        s = train.run(argv + ["--quiet"] + (["--metrics", rows_path] if metrics else []))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {k.__name__: k.launches - getattr(k, "launches_f64", 0) for k in kerns}
        got.update(lda_estep_f64=lda_estep.launches_f64, flda_estep_f64=flda_estep.launches_f64)
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        rows = ([json.loads(line) for line in open(rows_path)] if metrics else [])
        need(not metrics or [r["k"] for r in rows] == list(range(1, s.get("iterations", 0) + 1)),
             f"phase 14 {label}: metrics rows {[r['k'] for r in rows]}")
        need(s.get("final_elbo") is not None and np.isfinite(s["final_elbo"]),
             f"phase 14 {label}: final elbo {s.get('final_elbo')}")
        print(f"phase 14 CLI {label}: {wall:.2f} s; " + ", ".join(
            f"{k} {v:.6g}" if isinstance(v, float) else f"{k} {v}" for k, v in s.items())
            + f"; launches {got}")
        return s, [r["delta_elbo"] for r in rows], got

    nsf = ["--corpus", "nsf-scale", "--k", str(K)]
    chunks = types.SimpleNamespace(packed=bucketed, chunk_docs=1024)
    n_chunks, n_scatter = n_chunks_of(chunks), scatters_of(chunks)
    padded = sum(seg.terms.size for seg in bucketed.segments)
    peak = engine.device_peak_flops(dev)
    prof, ckpt = os.path.join(tmp, "prof"), os.path.join(tmp, "lda.ckpt")

    # LDA at full width, with the metrics and a checkpoint: its steps' time,
    # docs/s and MFU; the profiler's own cost would swamp them, so it
    # captures a run of its own
    s, deltas, got = cli("LDA NSF", ["--model", "lda", *nsf, "--iter", "5", "--checkelbo", "1",
                                     "--save", ckpt])
    need(s["iterations"] == 5 and all(d > 0 for d in deltas), f"phase 14 LDA: ∆elbo {deltas}")
    need(s["docs_per_s"] > 0 and 0 < s.get("mfu", 0) <= 1, f"phase 14 LDA: mfu {s.get('mfu')}")
    need(s["flops_per_step"] == float(10 * padded * 6 * K),
         f"phase 14 LDA: flops_per_step {s['flops_per_step']}")
    need(got["lda_estep"] == 5 * n_chunks and got["lda_elbo_tok"] == 6 * n_chunks
         and got["scatter_rows"] == 5 * n_scatter and got["lda_estep_f64"] == 0,
         f"phase 14 LDA: launches {got} for {n_chunks} chunks")
    print(f"phase 14: peak {peak / 1e12:.2f} TFLOP/s (SMs x 128 x 2 x max SM clock), LDA "
          f"NSF step+bound {s['mean_step_s']:.4f} s, {s['docs_per_s']:.0f} docs/s, "
          f"{s['tflops_per_s']:.4f} TFLOP/s, mfu {s.get('mfu', 0.0):.4%}; card {smi}")
    lda_elbo = s["final_elbo"]

    # the profiler: iteration 2 of a 2-iteration run (and its bound), CPU
    # and CUDA activity, on 16,384 of the documents (under the profiler a
    # full NSF step takes ~5 s)
    s, _, got = cli("LDA NSF profiled", ["--model", "lda", *nsf, "--subset", "16384", "--iter",
                                         "2", "--checkelbo", "2", "--profile-dir", prof])
    per_step = got["lda_estep"] // 2
    (trace,) = os.listdir(prof)
    with open(os.path.join(prof, trace)) as f:
        events = json.load(f)["traceEvents"]
    steps = sum(e.get("name") == "cavi_step" and e.get("cat") == "user_annotation"
                for e in events)
    kern_events = sum("lda_estep_kernel" in e.get("name", "") for e in events)
    # CUPTI may drop an activity record: the trace must hold the kernel,
    # not every launch
    need(trace == "trace_iter000002-000002.json" and steps == 1 and per_step > 0
         and 0 < kern_events <= per_step,
         f"phase 14 LDA: trace {trace} has {steps} cavi_step and {kern_events} lda_estep "
         f"events; launches {got}")
    print(f"phase 14: trace {trace} ({os.path.getsize(os.path.join(prof, trace)) / 2**20:.1f} "
          f"MiB): {len(events)} events, {kern_events} lda_estep kernels of {per_step} "
          f"launched; the profiled step {s['mean_step_s']:.4f} s")

    # the checkpoint resumes
    m = tt.load_checkpoint(ckpt, kc["packed"], device=dev)
    need(m.trained_iters == 5 and m.elbo == lda_elbo, "phase 14: the CLI checkpoint's counters")
    m.train(iter=1, checkelbo=1, printelbo=False)
    r = m.trainer.trace[-1]
    need(r.k == 6 and r.delta_elbo > 0, f"phase 14: resume k {r.k}, ∆elbo {r.delta_elbo}")
    print(f"phase 14: the CLI's checkpoint ({os.path.getsize(ckpt) / 2**20:.1f} MiB) resumed "
          f"at k = 6, ∆elbo {r.delta_elbo:.3f}")

    # the f64 Elogtheta channel: LDA, then fLDA
    s, deltas, got = cli("LDA NSF elogtheta-f64", ["--model", "lda", *nsf, "--iter", "5",
                                                   "--checkelbo", "1", "--elogtheta-f64"])
    need(all(d > 0 for d in deltas), f"phase 14 LDA f64: ∆elbo {deltas}")
    need(got["lda_estep_f64"] == 5 * n_chunks and got["lda_estep"] == 0,
         f"phase 14 LDA f64: launches {got}")
    print(f"phase 14: final elbo f32 channel {lda_elbo:.3f}, f64 channel {s['final_elbo']:.3f}")
    s, deltas, got = cli("fLDA NSF elogtheta-f64", ["--model", "flda", *nsf, "--iter", "4",
                                                    "--checkelbo", "1", "--elogtheta-f64"])
    need(all(d > 0 for d in deltas[1:]), f"phase 14 fLDA f64: ∆elbo {deltas}")
    need(got["flda_estep_f64"] == 4 * n_chunks and got["flda_estep"] == 0
         and got["scatter_rows"] == 4 * n_scatter, f"phase 14 fLDA f64: launches {got}")

    # CTPF at CiteULike scale
    s, deltas, got = cli("CTPF CiteULike", ["--model", "ctpf", "--corpus", "citeu", "--k",
                                            str(K), "--iter", "3", "--checkelbo", "1"])
    need(s["M"] == kc["cpk"].M and all(d > 0 for d in deltas[1:]),
         f"phase 14 CTPF: M {s['M']}, ∆elbo {deltas}")
    need(got["ctpf_estep"] > 0 and got["ctpf_estep"] % 3 == 0 and got["scatter_rows"] > 0,
         f"phase 14 CTPF: launches {got}")

    # streaming LDA on the NSF corpus
    s, _, got = cli("StreamingLDA NSF", ["--model", "lda", *nsf, "--iter", "2", "--checkelbo",
                                         "1", "--streaming"], metrics=False)
    need(s["mode"] == "streaming" and got["lda_estep"] > 0 and got["scatter_rows"] > 0,
         f"phase 14 streaming: {s}, launches {got}")

    # python -m, one rank of an NCCL group
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    argv = [sys.executable, "-m", "topicmodelsvb_jl_torch.train", "--model", "lda",
            "--corpus", "nsf-scale", "--subset", "16384", "--k", str(K), "--iter", "2",
            "--json", "--coordinator", f"localhost:{port}", "--num-processes", "1",
            "--process-id", "0"]
    t0 = time.perf_counter()
    proc = subprocess.Popen(argv, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        out, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    need(proc.returncode == 0, f"phase 14 NCCL rank exited {proc.returncode}: {err[-3000:]}")
    one = json.loads(out.strip().splitlines()[-1])
    need(one["iterations"] == 2 and one["M"] == 16384 and np.isfinite(one["final_elbo"])
         and 0 < one.get("mfu", 0) <= 1, f"phase 14 NCCL rank: {one}")
    print(f"phase 14: python -m ... --coordinator (one NCCL rank) in "
          f"{time.perf_counter() - t0:.1f} s: {one}")
    shutil.rmtree(tmp, ignore_errors=True)
    print(f"phase 14: wall {time.perf_counter() - t_phase:.1f} s; launches {launches}; "
          f"card {smi}")
    return launches, f64


def compare_double(seg, V, K, dev, label) -> dict:
    """Phase 16: the float64 modes of ``lda_estep``, ``lda_elbo_tok``,
    ``flda_estep`` and ``scatter_rows`` against their plain float64
    versions on one chunk, phase 3's arguments cast to float64: within
    RTOL64/ATOL64, bitwise repeatable, zeros on masked documents, each
    launch counted in its wrapper's ``launches_double``; device and call
    times; bounds with 8-byte elements (the int32 ids stay 4 bytes) and
    operations at the card's f64 rate (``engine.device_peak_flops``)."""
    import torch

    from topicmodelsvb_jl_torch import engine
    from topicmodelsvb_jl_torch.kernels import flda_estep as flda_mod
    from topicmodelsvb_jl_torch.kernels import lda_estep as estep_mod
    from topicmodelsvb_jl_torch.kernels.flda_estep import flda_estep, flda_estep_ref
    from topicmodelsvb_jl_torch.kernels.lda_elbo import lda_elbo_tok, lda_elbo_tok_ref
    from topicmodelsvb_jl_torch.kernels.lda_estep import lda_estep, lda_estep_ref
    from topicmodelsvb_jl_torch.utils.numerics import EPSILON

    d = lambda args: tuple(a.double() if torch.is_floating_point(a) else a for a in args)
    terms, counts, doc_mask = seg
    B, L = terms.shape
    keep = counts > 0
    kept, uniq = int(keep.sum()), n_unique(terms, keep)
    rate = engine.device_peak_flops(dev, torch.float64)
    kw = dict(viter=10, vtol=1.0 / K**2)
    largs, beta, beta_old = lda_args(seg, V, K, dev)
    largs = d(largs)
    boT = (beta_old.double() + EPSILON).T.contiguous()
    g2T = (boT * (torch.log(beta.double() + EPSILON).T - torch.log(boT))).contiguous()
    eargs = (boT, g2T, largs[1], largs[2], largs[3], largs[6], largs[7])
    cases = (
        ("lda_estep", lda_estep, lambda: lda_estep(*largs, **kw),
         lambda: lda_estep_ref(*largs, **kw), ("gamma", "El", "El_old", "w"),
         8 * (uniq * K + B * L + B + K + 6 * B * K + B * L * K) + 4 * B * L,
         lambda: 4 * K * fixpoint_work(estep_mod, lda_estep_ref, largs, kw,
                                       keep.sum(1).double()) + 2 * K * kept),
        ("flda_estep", flda_estep, None, None,
         ("gamma", "El", "El_old", "tau", "tau_old", "w"),
         8 * (uniq * (K + 1) + 3 * B * L + B + K + 1 + 6 * B * K + 2 * B * L
              + B * L * (K + 1)) + 4 * B * L, None),
        ("lda_elbo_tok", lda_elbo_tok, lambda: (lda_elbo_tok(*eargs),),
         lambda: (lda_elbo_tok_ref(*eargs),), ("bound",),
         8 * (2 * uniq * K + B * L + 2 * B + 2 * B * K) + 4 * B * L, lambda: 6 * K * kept))
    fargs = d(flda_args(seg, V, K, dev))
    out = {}
    for name, kern, run, ref, names, nbytes, ops in cases:
        if name == "flda_estep":
            run, ref = lambda: flda_estep(*fargs, **kw), lambda: flda_estep_ref(*fargs, **kw)
            ops = lambda: 4 * K * fixpoint_work(flda_mod, flda_estep_ref, fargs, kw,
                                                keep.sum(1).double()) + 2 * (K + 1) * kept
        rows_ok = ((lambda got: True) if name == "lda_elbo_tok"
                   else (lambda got: bool(torch.all(got[-1][doc_mask == 0] == 0))))
        out[name] = check_double(name, kern, run, ref, names, rows_ok, nbytes, ops, rate,
                                 f"{label} B={B} L={L} K={K}")
    w = lda_estep(*largs, **kw)[3]
    out["scatter_rows"] = compare_scatter(V, w.reshape(-1, K), terms, keep, dev,
                                          f"float64 LDA w, {label}")
    return out


def double_phase(smi, kc, dev) -> tuple:
    """Phase 16, float64 on the card: (a) the float64 modes of lda_estep,
    flda_estep, lda_elbo_tok and scatter_rows against their plain
    versions; (b) LDA, fLDA, CTM and fCTM on the NSF corpus cut to
    P16_DOCS documents (phase 13's dense cut) and the small DTM of phase 8
    (cgtol = 0), each on the card and on the CPU in float64 from one init,
    P16_ITERS iterations, within 1e-8 per iteration on the globals (rtol,
    atol 1e-12) and the bound (relative); (c) DTM at the mac shape in
    float64 and float32 on the card, 3 iterations from one init; (d)
    StreamingLDA and StreamingDTM in float64, 2 sweeps; (e) ``python -m
    topicmodelsvb_jl_torch.train --dtype float64`` for LDA with its MFU
    against the f64 peak; (f) a float64 checkpoint written on the CPU and
    resumed on the card, bitwise equal to a straight card run; (g) the
    gate refusing float16 CTPF, HMTM, StreamingHMTM and seq LDA on the
    card before any launch.  Returns the float64 modes' launches in (b)'s
    card runs and their records."""
    import numpy as np
    import torch

    import topicmodelsvb_jl_torch as tt
    from topicmodelsvb_jl_torch import convert, engine
    from topicmodelsvb_jl_torch.kernels.ctpf_estep import ctpf_estep
    from topicmodelsvb_jl_torch.kernels.flda_estep import flda_estep
    from topicmodelsvb_jl_torch.kernels.hmtm_estep import hmtm_estep, hmtm_logz
    from topicmodelsvb_jl_torch.kernels.lda_elbo import lda_elbo_tok
    from topicmodelsvb_jl_torch.kernels.lda_estep import lda_estep
    from topicmodelsvb_jl_torch.kernels.scatter_rows import scatter_rows
    from topicmodelsvb_jl_torch.models import lda as lda_mod

    t_phase = time.perf_counter()
    doubles = (scatter_rows, lda_estep, lda_elbo_tok, flda_estep)
    K, V = kc["K"], kc["V"]
    put = lambda a, dt: torch.as_tensor(np.ascontiguousarray(a), dtype=dt).to(dev)
    s0 = kc["bucketed"].segments[0]
    wide = (put(s0.terms[:1024], torch.int32), put(s0.counts[:1024], torch.float32),
            put(s0.doc_mask[:1024], torch.float32))

    # (a) the float64 modes at the main path's widest chunk
    recs = compare_double(wide, V, K, dev, f"widest bucket L={s0.L}")

    # (b) card against CPU in float64, from one init, per iteration; the
    # CPU's float64 references are the phase's cost, so the depth is cut
    # (2,048 documents, 2 iterations) and the widths kept
    launches = {f"{k.__name__}_double": 0 for k in doubles}
    nsf = p13_nsf(P16_DOCS)
    small = tt.synth_corpus(M=1500, V=600, K=8, seed=3, n_slices=5, drift=0.2, mean_tokens=60,
                            mean_terms=40)
    cases = (("LDA", lambda rt, d: tt.LDA(nsf, K, rt, device=d, seed=7), ("alpha", "beta"), {}),
             ("fLDA", lambda rt, d: tt.fLDA(nsf, K, rt, device=d, seed=7),
              ("alpha", "beta", "kappa", "eta"), {}),
             ("CTM", lambda rt, d: tt.CTM(nsf, 50, rt, device=d, seed=7), ("mu", "sigma", "beta"),
              {}),
             ("fCTM", lambda rt, d: tt.fCTM(nsf, 50, rt, device=d, seed=7),
              ("mu", "sigma", "beta", "kappa"), {}),
             ("DTM", lambda rt, d: tt.DTM(small, 10, delta=1.0, runtime=rt, device=d, seed=1),
              ("alpha", "betahat", "mbeta"), dict(cgiter=5, cgtol=0.0)))
    models = {}
    for fam, make, fields, train_kw in cases:
        chunk = 2048 if fam in ("CTM", "fCTM") else 1024 if fam != "DTM" else 256
        rt = tt.RuntimeConfig(chunk_docs=chunk, dtype="float64")
        to_np = getattr(convert, f"{fam.lower()}_state_to_numpy")
        from_np = getattr(convert, f"{fam.lower()}_state_from_numpy")
        gpu, cpu = make(rt, dev), make(rt, "cpu")
        cpu.state = from_np(to_np(gpu.state), "cpu", torch.float64)
        worst, rels, deltas = 0.0, [], []
        t_card = t_cpu = 0.0
        for it in range(P16_ITERS):
            for k in doubles:
                k.launches_double = 0
            _, s_card = timed(lambda: gpu.train(iter=1, checkelbo=1, printelbo=False,
                                                **train_kw))
            for k in doubles:
                launches[f"{k.__name__}_double"] += k.launches_double
            t0 = time.perf_counter()
            cpu.train(iter=1, checkelbo=1, printelbo=False, **train_kw)
            t_cpu += time.perf_counter() - t0
            t_card += s_card
            a, b = gpu.trainer.trace[-1].elbo, cpu.trainer.trace[-1].elbo
            deltas.append(gpu.trainer.trace[-1].delta_elbo)
            rels.append(abs(a - b) / abs(b))
            need(rels[-1] <= 1e-8, f"phase 16 {fam}: iteration {it + 1} bound {a} vs CPU {b}")
            for f in fields:
                x, y = getattr(gpu.state, f).cpu(), getattr(cpu.state, f)
                need(x.dtype == torch.float64 and y.dtype == torch.float64,
                     f"phase 16 {fam}: {f} not float64")
                ok = torch.allclose(x, y, rtol=1e-8, atol=1e-12)
                worst = max(worst, float(((x - y).abs() / (1e-12 + y.abs())).max()))
                need(ok, f"phase 16 {fam}: iteration {it + 1}: {f} beyond 1e-8 of the CPU's")
        need(all(d > 0 for d in deltas[1:]), f"phase 16 {fam}: ∆elbo {deltas}")
        models[fam] = (gpu, cpu, rels)
        print(f"phase 16 {fam} float64 (M={gpu.M}, K={gpu.K}, chunk {chunk}): card vs CPU from "
              f"one init, {P16_ITERS} iterations: bound rel diff per iteration "
              f"{', '.join(f'{r:.3e}' for r in rels)}, worst rel diff of {', '.join(fields)} "
              f"{worst:.3e}; card {t_card:.2f} s, CPU {t_cpu:.2f} s; ∆elbo "
              f"{', '.join(f'{x:.3f}' for x in deltas)}")
    for k in doubles:
        need(launches[f"{k.__name__}_double"] > 0,
             f"phase 16: {k.__name__}'s float64 mode never launched: {launches}")

    # (c) DTM at the mac shape: float32 against float64 on the card, from
    # the float64 init cast to float32
    corp = mac_corpus()
    m64 = tt.DTM(corp, 20, delta=1.0, runtime=tt.RuntimeConfig(dtype="float64"), device=dev,
                 seed=7)
    m32 = tt.DTM(corp, 20, delta=1.0, device=dev, seed=7)
    m32.state = convert.dtm_state_from_numpy(convert.dtm_state_to_numpy(m64.state), dev,
                                             torch.float32)
    walls, n64 = {}, {}
    for tag, m in (("float64", m64), ("float32", m32)):
        d0 = scatter_rows.launches_double
        _, walls[tag] = timed(lambda: m.train(iter=3, checkelbo=1, printelbo=False, cgiter=10))
        n64[tag] = scatter_rows.launches_double - d0
    need(n64["float64"] > 0 and n64["float32"] == 0,
         f"phase 16 DTM mac: float64 scatter launches {n64}")
    norm = lambda f: float(torch.linalg.norm(getattr(m32.state, f).double() - getattr(m64.state, f))
                           / torch.linalg.norm(getattr(m64.state, f)))
    e64, e32 = m64.trainer.trace[-1].elbo, m32.trainer.trace[-1].elbo
    print(f"phase 16 DTM mac (M={m64.M}, V={m64.V}, T={m64.T}, K=20), 3 iterations (cgiter 10) "
          f"from one init on the card: float32 departs from float64 by {norm('betahat'):.3e} "
          f"(betahat), {norm('mbeta'):.3e} (mbeta), {norm('alpha'):.3e} (alpha) of the norm and "
          f"{abs(e32 - e64) / abs(e64):.3e} on the bound; beside it the float64 card run "
          f"departs from the CPU by at most {max(models['DTM'][2]):.3e} on the bound (the small "
          f"DTM of (b)); 3 iterations float64 {walls['float64']:.2f} s, float32 "
          f"{walls['float32']:.2f} s; card {smi}")
    recs["scatter_dtm"] = dtm_chunk_scatter(m64, dev, "mac float64")
    del m64, m32

    # (d) the streaming forms in float64
    sdtm_c = tt.pack_corpus(small, docs_multiple=1024)
    T, sid = tt.slices_from_stamps([doc.stamp for doc in small.docs], 1.0, sdtm_c.M_pad)
    for name, make, train_kw in (
            ("StreamingLDA", lambda: tt.StreamingLDA(nsf, K, batch_docs=1024, chunk_docs=1024,
                                                     dtype=torch.float64, seed=3, device=dev),
             {}),
            ("StreamingDTM", lambda: tt.StreamingDTM(sdtm_c, 10, T, sid, batch_docs=1024,
                                                     chunk_docs=256, dtype=torch.float64,
                                                     seed=3, device=dev),
             dict(cgiter=5, cgtol=0.0))):
        for k in doubles:
            k.launches_double = 0
        sm = make()
        _, wall = timed(lambda: sm.train(iter=2, checkelbo=1, printelbo=False, **train_kw))
        got = {k.__name__: k.launches_double for k in doubles}
        elbos = [e for _, e, _ in sm.trace]
        need(sm.dtype == torch.float64 and got["scatter_rows"] > 0 and len(elbos) >= 2
             and np.all(np.isfinite(elbos)), f"phase 16 {name}: launches {got}, trace {sm.trace}")
        print(f"phase 16 {name} float64, 2 sweeps: {wall:.2f} s, trace {sm.trace}, float64 "
              f"launches {got}")
        for k, v in got.items():
            launches[f"{k}_double"] += v

    # (e) the CLI as a user runs it, with its MFU against the f64 peak
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "topicmodelsvb_jl_torch.train", "--model",
                           "lda", "--corpus", "nsf-scale", "--subset", "8192", "--k", str(K),
                           "--iter", "2", "--dtype", "float64", "--json"], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    need(proc.returncode == 0, f"phase 16 CLI exited {proc.returncode}: {proc.stderr[-3000:]}")
    one = json.loads(proc.stdout.strip().splitlines()[-1])
    peak64 = engine.device_peak_flops(dev, torch.float64)
    need(one["iterations"] == 2 and np.isfinite(one["final_elbo"]) and 0 < one.get("mfu", 0) <= 1
         and abs(one["mfu"] * peak64 * one["mean_step_s"] - one["flops_per_step"])
         <= 1e-6 * one["flops_per_step"], f"phase 16 CLI: {one}")
    print(f"phase 16: python -m topicmodelsvb_jl_torch.train --dtype float64 (LDA, 8,192 "
          f"documents, K = {K}) in {time.perf_counter() - t0:.1f} s: mean step "
          f"{one['mean_step_s']:.4f} s, mfu {one.get('mfu', 0.0):.4%} of the f64 peak "
          f"{peak64 / 1e12:.2f} TFLOP/s (SMs x 64 x 2 x max SM clock); {one}")

    # (f) a float64 checkpoint written on the CPU, resumed on the card
    gpu, cpu, _ = models["LDA"]
    os.makedirs(os.path.join(ROOT, "_tmp"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "_tmp")) as tmp:
        path = os.path.join(tmp, "lda64.npz")
        tt.save_checkpoint(path, cpu)
        back = tt.load_checkpoint(path, nsf, device=dev)
    straight = tt.LDA(nsf, K, tt.RuntimeConfig(chunk_docs=1024, dtype="float64"), device=dev,
                      seed=7)
    straight.state = convert.lda_state_from_numpy(convert.lda_state_to_numpy(cpu.state), dev,
                                                  torch.float64)
    need(back.device.type == "cuda" and back.dtype == torch.float64
         and back.trained_iters == P16_ITERS, "phase 16: the float64 checkpoint's model")
    for m in (back, straight):
        m.train(iter=2, checkelbo=1, printelbo=False)
    fields = tuple(vars(straight.state))
    equal_states(back.state, straight.state, fields,
                 "phase 16: a CPU float64 checkpoint resumed on the card vs a straight card run")
    print(f"phase 16: an LDA float64 checkpoint written on the CPU at iteration {P16_ITERS} "
          "resumed on the card for 2 iterations: bitwise equal to a straight card run from that "
          "state")

    # (g) the gate: float16 refused before any launch or allocation (every
    # kernel has float32 and float64 modes)
    from topicmodelsvb_jl_torch.ops.packing import unit_counts

    allk = (scatter_rows, lda_estep, lda_elbo_tok, flda_estep, ctpf_estep, hmtm_estep, hmtm_logz)
    rt16 = tt.RuntimeConfig(chunk_docs=1024, dtype="float16")
    hm_corpus = unit_counts(nsf)
    seq_step = lda_mod.make_step(nsf, K, 10, 1e-4, 10, 1e-4, 1024, dev, seq_axis="seq")
    half = types.SimpleNamespace(beta=types.SimpleNamespace(dtype=torch.float16, device=dev))
    torch.cuda.synchronize()
    before, mem0 = [k.launches for k in allk], torch.cuda.memory_allocated()
    refusals = []
    for what, call in (("CTPF", lambda: tt.CTPF(kc["cpk"], K, rt16, device=dev)),
                       ("HMTM", lambda: tt.HMTM(hm_corpus, 25, rt16, device=dev)),
                       ("StreamingHMTM", lambda: tt.StreamingHMTM(
                           hm_corpus, 25, batch_docs=1024, chunk_docs=1024, dtype="float16",
                           device=dev)),
                       ("LDA seq", lambda: seq_step(half, None, None, None, None))):
        try:
            call()
        except TypeError as e:
            need("in float16 on CUDA" in str(e), f"phase 16: float16 {what}: {e}")
            refusals.append(f"{what}: {e}")
        else:
            need(False, f"phase 16: float16 {what} on the card was not refused")
    torch.cuda.synchronize()
    need([k.launches for k in allk] == before and torch.cuda.memory_allocated() == mem0,
         "phase 16: a refused float16 run launched or allocated")
    print("phase 16: refused before any launch or allocation: " + "; ".join(refusals))
    print(f"phase 16: wall {time.perf_counter() - t_phase:.1f} s; float64 launches of (b) and "
          f"(d) {launches}; card {smi}")
    return launches, recs


def check_double(name, kern, run, ref, names, masked_ok, nbytes, ops, rate, label,
                 plain_once=False) -> dict:
    """Phase 17: one float64 mode against its plain float64 version on one
    chunk: within RTOL64/ATOL64, every output float64 and finite, bitwise
    repeatable, ``masked_ok(got)`` (zeros or the state as given on masked
    documents), its launch counted in the wrapper's ``launches_double``;
    device and call times, the plain version's (one call on the host
    clock with ``plain_once``) and the bound (``nbytes``; ``ops()``
    operations at ``rate``).  Returns the record."""
    import torch

    tup = lambda x: (x,) if torch.is_tensor(x) else tuple(x)
    n0, d0 = kern.launches, kern.launches_double
    got = tup(run())
    torch.cuda.synchronize()
    need((kern.launches, kern.launches_double) == (n0 + 1, d0 + 1),
         f"{name} float64 {label}: the float64 mode did not launch")
    if plain_once:
        want, plain_s = timed(lambda: tup(ref()))
        plain = (plain_s * 1e3, plain_s * 1e3)
    else:
        want, plain = tup(ref()), time_calls(ref, N_PLAIN, reps=1)
    need(all(a.dtype == torch.float64 for a in got), f"{name} float64 {label}: dtype")
    err = close(got, want, names, f"{name} float64 {label}", RTOL64, ATOL64)
    need(all(torch.equal(a, b) for a, b in zip(got, tup(run()))),
         f"{name} float64 {label}: not bitwise repeatable")
    need(masked_ok(got), f"{name} float64 {label}: a masked document moved or got rows")
    rec = record(err, time_calls(run, N_KERNEL), plain, bound_ms(nbytes, ops(), rate))
    print(f"kernels float64 {label}: {name} {times(rec)}")
    return rec


def hmtm_wide_args(K, B, L, V, dev, seed, dtype):
    """A synthetic HMTM chunk at K topics (``hmtm_state``'s tables and
    state): documents of random lengths up to L, one empty, one of one
    token, one whose first 5 slots are padding, and the last 3 with
    doc_mask 0."""
    import numpy as np
    import torch

    r = np.random.default_rng(seed)
    n = r.integers(L // 2, L + 1, size=B)
    n[0], n[1] = 0, 1
    tmask = np.arange(L)[None, :] < n[:, None]
    tmask[2, :5] = False
    dm = np.ones(B)
    dm[-3:] = 0.0
    put = lambda a, dt: torch.as_tensor(np.ascontiguousarray(a), dtype=dt).to(dev)
    terms = put(np.minimum((V * r.random((B, L)) ** 3).astype(np.int32), V - 1) * tmask,
                torch.int32)
    betaT, eta, alpha, tau, gamma = (t.to(dtype) for t in hmtm_state(K, B, V, dev, seed))
    return betaT, terms, put(tmask, dtype), put(dm, dtype), eta, alpha, tau, gamma


def dtype_phase(smi, kc, dev, ranks) -> tuple:
    """Phase 17, every dtype and K on the card: (a) the float64 modes of
    ctpf_estep, its pass mode, lda_estep_pass, flda_estep_pass, hmtm_estep
    and hmtm_logz against their plain float64 versions on the widest
    chunk of each main path cast to float64 (``check_double``); (b) the
    HMTM wide mode in float32 at K = 240, 256, 257, 300 and 512, and in
    float64 at K = 169 (A in shared memory) and 170 (wide), on small
    chunks, and on the widest NSF chunk at K = 300 with its times; (c)
    CTPF at CiteULike scale (K = 100, every document) in float64 on the
    card against the CPU from one init, the CPU at a cut depth (its first
    iteration); (d) HMTM K = 25 on NSF unit counts cut to P16_DOCS
    documents in float64, card against CPU, 2 iterations; (e) HMTM K =
    300 in float32 on the NSF vocabulary cut to P16_DOCS documents, 2
    iterations, through the wide mode; (f) phase 13's two ranks' float64
    runs of P17_RANK_CASES (``ranks``) against one float64 process; (g)
    the CLI with ``--model ctpf --dtype float64`` and ``--model hmtm --k
    300``.  Each main run's counts are set to 0 before and read after.
    Returns (launches, records)."""
    import numpy as np
    import torch

    import topicmodelsvb_jl_torch as tt
    from topicmodelsvb_jl_torch import convert, engine
    from topicmodelsvb_jl_torch import train as train_cli
    from topicmodelsvb_jl_torch.kernels import ctpf_estep as ctpf_mod
    from topicmodelsvb_jl_torch.kernels import hmtm_estep as hmtm_mod
    from topicmodelsvb_jl_torch.kernels.ctpf_estep import (
        ctpf_estep, ctpf_estep_pass, ctpf_estep_pass_ref, ctpf_estep_ref,
    )
    from topicmodelsvb_jl_torch.kernels.flda_estep import flda_estep_pass, flda_estep_pass_ref
    from topicmodelsvb_jl_torch.kernels.hmtm_estep import (
        hmtm_estep, hmtm_estep_ref, hmtm_logz, hmtm_logz_ref,
    )
    from topicmodelsvb_jl_torch.kernels.lda_estep import lda_estep_pass, lda_estep_pass_ref
    from topicmodelsvb_jl_torch.ops.packing import unit_counts
    from topicmodelsvb_jl_torch.utils.numerics import EPSILON, dirichlet_ones

    t_phase = time.perf_counter()
    f64, i32 = torch.float64, torch.int32
    K, V, cpk = kc["K"], kc["V"], kc["cpk"]
    rate = engine.device_peak_flops(dev, f64)
    d = lambda args: tuple(a.double() if torch.is_floating_point(a) else a for a in args)
    put = lambda a, dt: torch.as_tensor(np.ascontiguousarray(a), dtype=dt).to(dev)
    recs, launches = {}, {}

    # (a) the float64 modes on their main paths' widest chunks
    cbk = tt.bucketize_packed(cpk, chunk=1024, pad_multiple=8)
    tok, rd = ctpf_bucket(cpk, cbk, dev)
    cargs, ckw = ctpf_args(tok, rd, cpk.V, cpk.U, K, dev)
    cargs = d(cargs)
    (terms, counts, dm), (readers, ratings) = tok, rd
    B, L, R = terms.shape[0], terms.shape[1], readers.shape[1]
    kt, kr = counts > 0, ratings > 0
    kept = int(kt.sum()) + int(kr.sum())
    pad = dm == 0
    rows = n_unique(terms, kt) + n_unique(readers, kr)
    recs["ctpf_estep_double"] = check_double(
        "ctpf_estep", ctpf_estep, lambda: ctpf_estep(*cargs, **ckw),
        lambda: ctpf_estep_ref(*cargs, **ckw),
        ("gimel", "gimel_old", "zayin", "zayin_old", "wa", "wh"),
        lambda got: (all(torch.equal(a[pad], b[pad]) for a, b in zip(got[:4], cargs[10:]))
                     and all(bool(torch.all(w[pad] == 0)) for w in got[4:])),
        8 * (rows * K + B * (L + R) + B + 3 * K + 8 * B * K + B * (L + R) * K) + 4 * B * (L + R),
        lambda: 4 * K * fixpoint_work(ctpf_mod, ctpf_estep_ref, cargs, ckw,
                                      (kt.sum(1) + kr.sum(1)).double()) + 2 * K * kept,
        rate, f"CiteULike widest bucket B={B} L={L} R={R} K={K}")
    # the pass modes on rank 0's half of the token (and reader) slots of the
    # first 1024 documents of their main paths (phases 13 and 15)
    pk = kc["packed"]
    h = pk.L // 2
    seg = (put(pk.terms[:1024, :h], i32), put(pk.counts[:1024, :h], f64),
           put(pk.doc_mask[:1024], f64))
    terms, counts, dm = seg
    keep = counts > 0
    kept, uniq = int(keep.sum()), n_unique(terms, keep)
    B, L = terms.shape
    betaT = (dirichlet_ones(torch.Generator().manual_seed(13), V, (K,)).to(dev)
             + EPSILON).T.contiguous().double()
    El = warm_state(K, B, dev, seed=14)[2].double()
    largs = (betaT, terms, counts, dm, El)
    recs["lda_estep_pass_double"] = check_double(
        "lda_estep_pass", lda_estep_pass, lambda: lda_estep_pass(*largs),
        lambda: lda_estep_pass_ref(*largs), ("pc",),
        lambda got: bool(torch.all(got[0][dm == 0] == 0)),
        8 * (uniq * K + B * L + B + 2 * B * K) + 4 * B * L, lambda: 4 * K * kept + B * K, rate,
        f"seq, NSF token half 0 of 2, B={B} L={L} K={K}")
    fa = d(flda_args((seg[0], seg[1].float(), seg[2].float()), V, K, dev))
    pargs = (fa[0], fa[1], terms, counts, dm, fa[6], fa[8], fa[10])
    live = (dm > 0)[:, None].expand(B, L)
    slots = int(live.sum())
    recs["flda_estep_pass_double"] = check_double(
        "flda_estep_pass", flda_estep_pass, lambda: flda_estep_pass(*pargs),
        lambda: flda_estep_pass_ref(*pargs), ("pc", "tau_new"),
        lambda got: (bool(torch.all(got[0][dm == 0] == 0))
                     and torch.equal(got[1][dm == 0], pargs[7][dm == 0])),
        8 * (n_unique(terms, live) * (K + 1) + 3 * B * L + B + 1 + 2 * B * K) + 4 * B * L,
        lambda: 4 * K * slots + 2 * K * kept, rate,
        f"seq, NSF token half 0 of 2, B={B} L={L} K={K}")
    hl, hr = cpk.L // 2, cpk.Rmax // 2
    ctok = (put(cpk.terms[:1024, :hl], i32), put(cpk.counts[:1024, :hl], torch.float32),
            put(cpk.doc_mask[:1024], torch.float32))
    crd = (put(cpk.readers[:1024, :hr], i32), put(cpk.ratings[:1024, :hr], torch.float32))
    pa, _ = ctpf_args(ctok, crd, cpk.V, cpk.U, K, dev)
    pa = d(pa)
    cp = (*pa[:10], pa[10], pa[12])
    ct, cr = cp[3] > 0, cp[5] > 0
    recs["ctpf_estep_pass_double"] = check_double(
        "ctpf_estep_pass", ctpf_estep_pass, lambda: ctpf_estep_pass(*cp),
        lambda: ctpf_estep_pass_ref(*cp), ("gsum", "zsum"),
        lambda got: all(bool(torch.all(x[cp[6] == 0] == 0)) for x in got),
        8 * ((n_unique(cp[2], ct) + n_unique(cp[4], cr)) * K + 1024 * (hl + hr) + 1024 + 3 * K
             + 4 * 1024 * K) + 4 * 1024 * (hl + hr),
        lambda: 4 * K * (int(ct.sum()) + int(cr.sum())) + 8 * K * int((cp[6] > 0).sum()), rate,
        f"seq, CiteULike token and reader halves 0 of 2, L={hl} R={hr} K={K}")
    # HMTM: phase 9's widest NSF chunk with unit counts, K = 25, viter 10
    label, Kh, viter, _, hargs = hmtm_chunks(kc["bucketed"], V, dev)[0]
    hargs = d(hargs)
    hkw = dict(viter=viter, vtol=1.0 / Kh**2)
    tmask, hdm = hargs[2], hargs[3]
    B, L = tmask.shape
    real = tmask.sum(1)
    n_real = float(real.sum())
    huniq = n_unique(hargs[1], tmask > 0)
    hpad = hdm == 0
    rec = check_double(
        "hmtm_estep", hmtm_estep, lambda: hmtm_estep(*hargs, **hkw),
        lambda: hmtm_estep_ref(*hargs, **hkw), ("tau", "gamma", "r"),
        lambda got: (torch.equal(got[0][hpad], hargs[6][hpad])
                     and torch.equal(got[1][hpad], hargs[7][hpad])
                     and bool(torch.all(got[2][tmask == 0] == 0))),
        8 * (huniq * Kh + B * L + B + Kh + Kh * Kh + 2 * B * Kh + 2 * B * Kh * Kh + B * L * Kh)
        + 4 * B * L,
        lambda: (6 * Kh * Kh * fixpoint_work(hmtm_mod, hmtm_estep_ref, hargs, hkw, real)
                 + 4 * Kh * Kh * n_real), rate, f"{label} B={B} K={Kh}", plain_once=True)
    recs["hmtm_estep_double"] = rec
    tg = hmtm_estep(*hargs, **hkw)
    zargs = (*hargs[:3], tg[0], tg[1])
    recs["hmtm_logz_double"] = check_double(
        "hmtm_logz", hmtm_logz, lambda: hmtm_logz(*zargs), lambda: hmtm_logz_ref(*zargs),
        ("logZ",), lambda got: bool(torch.all(torch.isfinite(got[0]))),
        8 * (huniq * Kh + B * L + B * Kh + B * Kh * Kh + B) + 4 * B * L,
        lambda: 2 * Kh * Kh * n_real, rate, f"{label} B={B} K={Kh}", plain_once=True)
    del tg, zargs, hargs

    # (b) the wide mode: f32 at K = 240, 256, 257, 300, 512 and f64 on both
    # sides of its float64 boundary, on small chunks; then the widest NSF
    # chunk at K = 300 (the main path (e)'s widths) with its times
    for Kw, dt in ((240, torch.float32), (256, torch.float32), (257, torch.float32),
                   (300, torch.float32), (512, torch.float32), (169, f64), (170, f64)):
        wargs = hmtm_wide_args(Kw, 16, 48, V, dev, Kw, dt)
        wkw = dict(viter=3, vtol=1.0 / Kw**2)
        want_mode = 3 if Kw >= (170 if dt == f64 else 240) else 2
        got_mode = hmtm_mod.mode(48, Kw, dt)
        need(got_mode == want_mode, f"HMTM K={Kw} {dt}: mode {got_mode}, want {want_mode}")
        w0 = hmtm_estep.launches_wide
        got = hmtm_estep(*wargs, **wkw)
        want = hmtm_estep_ref(*wargs, **wkw)
        torch.cuda.synchronize()
        need(hmtm_estep.launches_wide - w0 == (want_mode == 3), f"HMTM K={Kw}: wide launches")
        tol = (RTOL64, ATOL64) if dt == f64 else (RTOL, ATOL)
        err = close(got, want, ("tau", "gamma", "r"), f"hmtm_estep K={Kw} {dt}", *tol)
        need(all(torch.equal(a, b) for a, b in zip(got, hmtm_estep(*wargs, **wkw))),
             f"hmtm_estep K={Kw} {dt}: not bitwise repeatable")
        wpad = wargs[3] == 0
        need(torch.equal(got[0][wpad], wargs[6][wpad]) and bool(torch.all(
            got[2][wargs[2] == 0] == 0)), f"hmtm_estep K={Kw} {dt}: padding")
        za = (*wargs[:3], got[0], got[1])
        z, zr = hmtm_logz(*za), hmtm_logz_ref(*za)
        zrel = float(((z - zr).abs() / zr.abs().clamp_min(1e-30)).max())
        need(torch.equal(z, hmtm_logz(*za)) and float(z[0]) == 0.0
             and zrel <= (RTOL64 if dt == f64 else 1e-5), f"hmtm_logz K={Kw} {dt}: rel {zrel}")
        print(f"kernels HMTM K={Kw} {str(dt)[6:]} (mode {got_mode}), B=16 L=48 viter 3: "
              f"hmtm_estep max abs err {err:.3e} (tolerance {tol}), bitwise repeatable; "
              f"hmtm_logz rel err {zrel:.3e}")
    seg0 = unit_counts(kc["bucketed"]).segments[0]
    wterms = put(seg0.terms[:1024], i32)
    wargs = (wterms, put(seg0.counts[:1024] > 0, torch.float32),
             put(seg0.doc_mask[:1024], torch.float32))
    betaT, eta, alpha, tau, gamma = hmtm_state(300, wterms.shape[0], V, dev, 48)
    w0 = hmtm_estep.launches_wide
    est, lz, _ = compare_hmtm(f"wide, widest NSF bucket L={seg0.L}", 300, 10, 3,
                              (betaT, *wargs, eta, alpha, tau, gamma), dev, calls=(2, 1))
    need(hmtm_estep.launches_wide > w0, "hmtm_estep K=300 NSF: not the wide mode")
    recs["hmtm_estep_wide"], recs["hmtm_logz_wide"] = est, lz
    del wargs, betaT, eta, alpha, tau, gamma
    torch.cuda.empty_cache()

    # (c) CTPF at CiteULike scale in float64: card against CPU from one
    # init; the CPU runs the first iteration only (its float64 references
    # are the phase's cost)
    rt64 = tt.RuntimeConfig(chunk_docs=1024, dtype="float64")
    fields = ("alef", "bet", "dalet", "he", "vav", "het")
    card = tt.CTPF(cpk, K, rt64, device=dev, seed=7)
    cpu = tt.CTPF(cpk, K, rt64, device="cpu", seed=7)
    cpu.state = convert.ctpf_state_from_numpy(convert.ctpf_state_to_numpy(card.state), "cpu", f64)
    ctpf_estep.launches_double = 0
    _, card_s = timed(lambda: card.train(iter=1, checkelbo=1, printelbo=False))
    first = {f: getattr(card.state, f).cpu() for f in fields}
    a, deltas = card.trainer.trace[-1].elbo, [card.trainer.trace[-1].delta_elbo]
    _, s2 = timed(lambda: card.train(iter=1, checkelbo=1, printelbo=False))
    deltas.append(card.trainer.trace[-1].delta_elbo)
    launches["ctpf_estep_double"] = ctpf_estep.launches_double
    need(ctpf_estep.launches_double > 0, "phase 17 CTPF float64: the float64 mode never launched")
    _, cpu_s = timed(lambda: cpu.train(iter=1, checkelbo=1, printelbo=False))
    b = cpu.trainer.trace[-1].elbo
    need(abs(a - b) <= 1e-8 * abs(b), f"phase 17 CTPF float64: iteration 1 bound {a} vs {b}")
    worst = 0.0
    for f in fields:
        x, y = first[f], getattr(cpu.state, f)
        need(x.dtype == f64 and torch.allclose(x, y, rtol=1e-8, atol=1e-12),
             f"phase 17 CTPF float64: iteration 1 {f} beyond 1e-8 of the CPU's")
        worst = max(worst, float(((x - y).abs() / (1e-12 + y.abs())).max()))
    need(deltas[-1] > 0 and np.isfinite(card.elbo), f"phase 17 CTPF float64: ∆elbo {deltas}")
    print(f"phase 17 CTPF CiteULike float64 (M={card.M}, U={card.U}, K={K}): card 2 iterations "
          f"{card_s + s2:.2f} s, ∆elbo {', '.join(f'{x:.3f}' for x in deltas)}; against the "
          f"CPU's first iteration ({cpu_s:.2f} s): bound rel diff {abs(a - b) / abs(b):.3e}, "
          f"worst rel diff of {', '.join(fields)} {worst:.3e}; ctpf_estep float64 launches "
          f"{launches['ctpf_estep_double']}; card {smi}")
    del card, cpu, first

    # (d) HMTM K = 25 in float64 on NSF unit counts, card against CPU
    hpk = unit_counts(tt.synth_packed_nsf_scale(M=P16_DOCS, chunk_docs=1024))
    hfields = ("eta", "alpha", "beta")
    card = tt.HMTM(hpk, 25, rt64, device=dev, seed=7)
    cpu = tt.HMTM(hpk, 25, rt64, device="cpu", seed=7)
    cpu.state = convert.hmtm_state_from_numpy(convert.hmtm_state_to_numpy(card.state), "cpu", f64)
    rels, worst, t_card, t_cpu = [], 0.0, 0.0, 0.0
    for k in (hmtm_estep, hmtm_logz):
        k.launches_double = 0
    for it in range(2):
        _, s_card = timed(lambda: card.train(iter=1, checkelbo=1, printelbo=False))
        t0 = time.perf_counter()
        cpu.train(iter=1, checkelbo=1, printelbo=False)
        t_cpu += time.perf_counter() - t0
        t_card += s_card
        a, b = card.trainer.trace[-1].elbo, cpu.trainer.trace[-1].elbo
        rels.append(abs(a - b) / abs(b))
        need(rels[-1] <= 1e-8, f"phase 17 HMTM float64: iteration {it + 1} bound {a} vs {b}")
        for f in hfields:
            x, y = getattr(card.state, f).cpu(), getattr(cpu.state, f)
            need(x.dtype == f64 and torch.allclose(x, y, rtol=1e-8, atol=1e-12),
                 f"phase 17 HMTM float64: iteration {it + 1} {f} beyond 1e-8 of the CPU's")
            worst = max(worst, float(((x - y).abs() / (1e-12 + y.abs())).max()))
    launches["hmtm_estep_double"] = hmtm_estep.launches_double
    launches["hmtm_logz_double"] = hmtm_logz.launches_double
    need(launches["hmtm_estep_double"] > 0 and launches["hmtm_logz_double"] > 0,
         f"phase 17 HMTM float64: launches {launches}")
    print(f"phase 17 HMTM NSF unit counts float64 (M={card.M}, K=25): card vs CPU from one init, "
          f"2 iterations: bound rel diff per iteration {', '.join(f'{x:.3e}' for x in rels)}, "
          f"worst rel diff of {', '.join(hfields)} {worst:.3e}; card {t_card:.2f} s, CPU "
          f"{t_cpu:.2f} s; float64 launches hmtm_estep {launches['hmtm_estep_double']}, "
          f"hmtm_logz {launches['hmtm_logz_double']}; card {smi}")
    del card, cpu

    # (e) HMTM K = 300 in float32 through the wide mode
    hmtm_estep.launches_wide = hmtm_logz.launches_wide = 0
    torch.cuda.reset_peak_memory_stats()
    model = tt.HMTM(hpk, 300, tt.RuntimeConfig(chunk_docs=1024), seed=7)
    _, wall = timed(lambda: model.train(iter=2, checkelbo=1, printelbo=False))
    deltas = [x.delta_elbo for x in model.trainer.trace]
    launches["hmtm_estep_wide"] = hmtm_estep.launches_wide
    launches["hmtm_logz_wide"] = hmtm_logz.launches_wide
    need(model.device.type == "cuda" and deltas[-1] > 0 and np.isfinite(model.elbo),
         f"phase 17 HMTM K=300: ∆elbo {deltas}")
    need(launches["hmtm_estep_wide"] == 2 * n_chunks_of(model)
         and launches["hmtm_logz_wide"] == 3 * n_chunks_of(model),
         f"phase 17 HMTM K=300: wide launches {launches}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"phase 17 HMTM NSF unit counts K=300 float32 (M={model.M}, V={model.V}, widths "
          f"{[s.L for s in model.packed.segments]}): train(iter=2, checkelbo=1) {wall:.2f} s, "
          f"∆elbo {', '.join(f'{x:.3f}' for x in deltas)}, step+ELBO "
          f"{', '.join(f'{x.step_time_s:.3f}' for x in model.trainer.trace)} s; wide launches "
          f"hmtm_estep {launches['hmtm_estep_wide']}, hmtm_logz {launches['hmtm_logz_wide']}; "
          f"peak mem {peak:.2f} GiB; card {smi}")
    del model
    torch.cuda.empty_cache()

    # (f) the token-splitting axes in float64 on two ranks against one
    # float64 process on the card, from one init
    kern = dict(p12_counters(), **pass_counters())
    corpora = dict(mpk=p13_nsf(8192), cpk=p13_citeu(cpk))
    g0 = ranks[0]
    for label, _, fam, key, _ in P17_RANK_CASES:
        pk = corpora["cpk" if key == "cpk" else "mpk"]
        _, trace, glob, _, wall = p13_case("[phase 17, one process]", None, fam, pk, 100, 2, kern,
                                           doc=("data",), dtype="float64")
        have = g0["arrays"]
        worst = {}
        for f, want in glob.items():
            if f == "elbo":
                continue
            got = have[f"{label}/{f}"]
            need(got.dtype == np.float64 and np.allclose(got, want, rtol=1e-8, atol=1e-12),
                 f"phase 17 {label}: {f} beyond 1e-8 of one float64 process")
            worst[f] = float(np.max(np.abs(got - want) / (1e-12 + np.abs(want))))
        rt_ = g0[f"{label}/trace"]
        rel = [abs(x - y) / abs(y) for x, y in zip(rt_, trace)]
        need(len(rt_) == 3 and max(rel) <= 1e-8, f"phase 17 {label}: bound per iteration {rel}")
        print(f"phase 17 {label} on two ranks vs one float64 process, 2 iterations: worst rel "
              f"{', '.join(f'{f} {v:.2e}' for f, v in worst.items())}; bound relative from the "
              f"init on {', '.join(f'{x:.2e}' for x in rel)}; one process in {wall:.2f} s; "
              f"card {smi}")
    # the ranks' float64 launches are phase 13's (main adds them there)
    for n in ("lda_estep_pass", "flda_estep_pass", "ctpf_estep_pass"):
        need(sum(info["launches"].get(f"{n}_double", 0) for info in ranks) > 0,
             f"phase 17: {n}'s float64 mode never launched on the ranks")

    # (g) the CLI as a user runs it
    for argv, kern_, attr in ((["--model", "ctpf", "--corpus", "citeu", "--k", str(K), "--iter",
                                "2", "--checkelbo", "1", "--dtype", "float64", "--quiet"],
                               ctpf_estep, "launches_double"),
                              (["--model", "hmtm", "--corpus", "nsf-scale", "--subset",
                                str(P16_DOCS), "--k", "300", "--iter", "2", "--checkelbo", "1",
                                "--quiet"], hmtm_estep, "launches_wide")):
        setattr(kern_, attr, 0)
        out, s = timed(lambda: train_cli.run(argv))
        n = getattr(kern_, attr)
        need(n > 0 and out["iterations"] == 2 and np.isfinite(out["final_elbo"]),
             f"phase 17 CLI {' '.join(argv)}: {kern_.__name__} {attr} {n}, {out}")
        key = "ctpf_estep_double" if attr == "launches_double" else "hmtm_estep_wide"
        launches[key] += n
        print(f"phase 17: python -m topicmodelsvb_jl_torch.train {' '.join(argv)} in {s:.1f} s: "
              f"{kern_.__name__} {attr} {n}; {out}")
    print(f"phase 17: wall {time.perf_counter() - t_phase:.1f} s; launches {launches}; "
          f"card {smi}")
    return launches, recs


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

    # 7. checkpoint and resume
    add(checkpoint_phase(lda, ctpf, packed, cpk, rt, smi))

    # 8. DTM at mac scale
    dtm_launches, sc_dtm = dtm_phase(smi, dev)
    add(dtm_launches)
    sc += sc_dtm

    # 9. HMTM at NSF scale
    hm_launches, hm = hmtm_phase(kc, smi, dev)
    add(hm_launches)
    sc += hm["scatter"]

    # 10. host-streamed training
    st_launches, st = streaming_phase(smi, dev, kc, lda.smoke_step_s)
    add(st_launches)
    need(all(st_launches[k] > 0 for k in st_launches),
         f"streaming phase: a kernel never launched: {st_launches}")
    sc.append(st["scatter"])

    # 12. the data axis across processes
    p12 = parallel_phase(smi, kc)
    need(all(p12.get(k, 0) > 0 for k in P12_KERNELS),
         f"phase 12: a kernel never launched on the ranks: {p12}")
    add(p12)

    # 13. tensor and sequence parallelism (its ranks also run phase 15's cases)
    p13, pass_rec, p13_ranks = tp_phase(smi, kc)
    need(all(p13.get(k, 0) > 0 for k in P12_KERNELS + tuple(pass_counters())),
         f"phase 13: a kernel never launched on the ranks: {p13}")
    add(p13)

    # 14. the CLI on the card, and the f64 Elogtheta modes
    p14, f64 = cli_phase(smi, kc, dev)
    need(all(p14.get(k, 0) > 0 for k in ("lda_estep", "lda_elbo_tok", "ctpf_estep",
                                         "scatter_rows", "lda_estep_f64", "flda_estep_f64")),
         f"phase 14: a kernel never launched: {p14}")
    add(p14)

    # 15. the sequence axis of fLDA, CTM, fCTM and CTPF
    p15 = seq_phase(smi, kc, dev, p13_ranks)
    add(p15["launches"])

    # 16. float64 on the card
    p16, dbl = double_phase(smi, kc, dev)
    add(p16)

    # 17. every dtype and K on the card
    p17, every = dtype_phase(smi, kc, dev, p13_ranks)
    add(p17)

    # 11. results: each kernel at its main path's widest chunk, with the
    # largest error over every shape it was held at
    slower = [f"{r['label']} ({r['ms']:.4f} vs {r['library_ms']:.4f} ms device, "
              f"{r['call_ms']:.4f} vs {r['library_call_ms']:.4f} ms a call)"
              for r in sc if r["ms"] > r["library_ms"] or r["call_ms"] > r["library_call_ms"]]
    print(f"scatter_rows against index_add_ on {len(sc)} shapes: slower on "
          f"{len(slower)}{': ' + '; '.join(slower) if slower else ''}")
    rows = []
    tpu = "topicmodelsvb_jl_tpu/kernels/"
    for name, src, where, main_rec, others in (
            ("lda_estep", "lda_estep.cu", tpu + "lda_estep.py:157", kc["estep"][0],
             (*kc["estep"][1:], st["estep"])),
            ("lda_elbo_tok", "lda_elbo.cu", tpu + "lda_elbo.py:119", kc["elbo"][0],
             (kc["elbo"][1], elbo_ctm, st["elbo"])),
            ("flda_estep", "flda_estep.cu", tpu + "flda_estep.py:112", kc["flda"][0],
             (*kc["flda"][1:], *p15["viter0"]["flda_estep"])),
            ("ctpf_estep", "ctpf_estep.cu", tpu + "ctpf_estep.py:105", kc["ctpf"][0],
             (*kc["ctpf"][1:], *p15["viter0"]["ctpf_estep"])),
            ("scatter_rows", "scatter_rows.cu", "bench_scatter_pallas.py:40", sc[0], sc[1:]),
            # no Pallas kernel behind these two: the JAX package's lax.scans
            ("hmtm_estep", "hmtm_estep.cu", "topicmodelsvb_jl_tpu/models/hmtm.py:218",
             hm["estep"][0], hm["estep"][1:]),
            ("hmtm_logz", "hmtm_estep.cu", "topicmodelsvb_jl_tpu/models/hmtm.py:139",
             hm["logz"][0], hm["logz"][1:]),
            # the per-pass body the JAX package runs in XLA under routing and
            # on the sequence axis
            ("lda_estep_pass", "lda_estep.cu", "topicmodelsvb_jl_tpu/models/lda.py:127",
             pass_rec, ()),
            # the per-pass bodies the JAX package runs in XLA on the sequence
            # axis (it turns the flda_estep and ctpf_estep kernels off there)
            ("flda_estep_pass", "flda_estep.cu", "topicmodelsvb_jl_tpu/models/flda.py:91",
             p15["flda_pass"][0], p15["flda_pass"][1:]),
            ("ctpf_estep_pass", "ctpf_estep.cu", "topicmodelsvb_jl_tpu/models/ctpf.py:127",
             p15["ctpf_pass"][0], p15["ctpf_pass"][1:]),
            # the f64 Elogtheta modes: the JAX package turns its Pallas kernels
            # off for them and runs its XLA chunk bodies
            ("lda_estep_f64", "lda_estep.cu", "topicmodelsvb_jl_tpu/models/lda.py:137",
             f64["lda_estep_f64"][0], f64["lda_estep_f64"][1:]),
            ("flda_estep_f64", "flda_estep.cu", "topicmodelsvb_jl_tpu/models/flda.py:106",
             f64["flda_estep_f64"][0], f64["flda_estep_f64"][1:]),
            # the float64 modes: the JAX package runs these kernels in the
            # state's dtype
            ("scatter_rows_double", "scatter_rows.cu", "bench_scatter_pallas.py:40",
             dbl["scatter_rows"], dbl["scatter_dtm"]),
            ("lda_estep_double", "lda_estep.cu", tpu + "lda_estep.py:157", dbl["lda_estep"], ()),
            ("lda_elbo_tok_double", "lda_elbo.cu", tpu + "lda_elbo.py:119", dbl["lda_elbo_tok"],
             ()),
            ("flda_estep_double", "flda_estep.cu", tpu + "flda_estep.py:112", dbl["flda_estep"],
             ()),
            ("ctpf_estep_double", "ctpf_estep.cu", tpu + "ctpf_estep.py:105",
             every["ctpf_estep_double"], ()),
            ("ctpf_estep_pass_double", "ctpf_estep.cu", "topicmodelsvb_jl_tpu/models/ctpf.py:127",
             every["ctpf_estep_pass_double"], ()),
            ("lda_estep_pass_double", "lda_estep.cu", "topicmodelsvb_jl_tpu/models/lda.py:127",
             every["lda_estep_pass_double"], ()),
            ("flda_estep_pass_double", "flda_estep.cu", "topicmodelsvb_jl_tpu/models/flda.py:91",
             every["flda_estep_pass_double"], ()),
            ("hmtm_estep_double", "hmtm_estep.cu", "topicmodelsvb_jl_tpu/models/hmtm.py:218",
             every["hmtm_estep_double"], ()),
            ("hmtm_logz_double", "hmtm_estep.cu", "topicmodelsvb_jl_tpu/models/hmtm.py:139",
             every["hmtm_logz_double"], ()),
            # the wide mode: any K, the JAX package's lax.scans at every width
            ("hmtm_estep_wide", "hmtm_estep.cu", "topicmodelsvb_jl_tpu/models/hmtm.py:218",
             every["hmtm_estep_wide"], ()),
            ("hmtm_logz_wide", "hmtm_estep.cu", "topicmodelsvb_jl_tpu/models/hmtm.py:139",
             every["hmtm_logz_wide"], ())):
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
    if sys.argv[1:2] == ["--p12"]:
        sys.exit(parallel_child(sys.argv[2], *map(int, sys.argv[3:6]), sys.argv[6]))
    if sys.argv[1:2] == ["--p13"]:
        sys.exit(tp_child(*map(int, sys.argv[2:5]), sys.argv[5]))
    sys.exit(main())
