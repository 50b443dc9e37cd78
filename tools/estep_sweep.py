"""Time ``lda_estep``, ``flda_estep``, ``ctpf_estep`` or ``hmtm_estep`` at
their main path's widest chunk and at a chunk whose rows do not fit shared
memory for a range of ``viter``, or ``lda_elbo_tok`` at LDA's chunks and
at CTM's (K = 50, 2048 documents), from the package of a given checkout,
with chip_smoke.py's timer.

    python3 tools/estep_sweep.py ROOT LABEL [lda|lda_double|flda|flda_double|ctpf|ctpf_double|elbo|hmtm|lda_pass|flda_pass|ctpf_pass|pass_main[:NAME]|scatter_double]

ROOT holds a checkout of this repository (``.`` for this one, or a
``git archive`` unpacked into a directory that ``.gitignore`` lists); its
``topicmodelsvb_jl_torch`` is imported and built.  The chunks and the warm
state are chip_smoke.py's (``kernel_checks``'s): for LDA and fLDA the
widest NSF bucket, 1024 documents, K = 100, and the synthetic L = 1024
chunk, with fLDA's tables, tau and eta as ``compare_flda`` draws them; for
CTPF the CiteULike corpus's widest bucket (L = 80, R = 24) and the
synthetic L = 768, R = 256 chunk, with ``ctpf_args``'s tables and state,
then the first chunk of each narrower bucket at viter 0 and 10;
for the bound ``compare_kernels``'s tables; for HMTM ``hmtm_chunks``'s
first three chunks (the widest NSF bucket with unit counts at K = 25 and
K = 100, and L = 4,096) with ``hmtm_logz`` beside each, then at one viter
its fourth (empty, one-token, padded-first and doc_mask 0 documents), the
widest chunk cast to float64, ``hmtm_wide_args`` chunks (64 documents of
L = 48, viter 3) at K = 300 in float32 and float64 and at K = 170 in
float64 (the float64 cluster mode's first K), and the widest NSF chunk at
K = 300 (``hmtm_k300_chunk``) at viter 10 and 0; those two K = 170 and
K = 300 timings take 5 calls (``hmtm_logz`` 10), the median of 2.  viter
= 0 runs no pass (the loads and the row writes alone, or at K = 300 the
final forward-backward alone); the slope over viter is the cost of a
pass.  ``lda_pass`` and ``flda_pass`` time the pass modes
(``lda_estep_pass``, ``flda_estep_pass``) on 1024 documents at L = 64 and
128 (the widest NSF bucket, its first 64 slots) and 512 and 1024
(chip_smoke.py's L = 1024 chunk ending in 3 padded documents, its first
512 slots), each at K = 25, 100 and 300 in float32 and at K = 100 in
float64, with chip_smoke.py's ``pass_args``/``flda_pass_args``; each
entry also gives the warp mode's shape (``pass_shape``: lanes a slot,
vectors a lane, warps a document; lanes 0: the block mode) and the ns a
kept slot (fLDA: a slot of a real document).  ``ctpf_pass`` times
``ctpf_estep_pass`` on 1024 CiteULike documents at (L, R) = (32, 8),
(64, 12) (the seq chunk), (80, 24) (the widest bucket) and on the
L = 768, R = 256 chunk's first (384, 128) and whole, each at K = 25, 100
and 300 in float32 and at K = 100 in float64, with chip_smoke.py's
``ctpf_args``; each entry gives the warp mode's shape and the ns a kept
slot.  ``flda_double`` times ``flda_estep``'s float64 mode like ``flda``
(the widest NSF bucket and the L = 1024 chunk, viter 0-10), plus the
widest bucket's first 64 slots.  ``pass_main`` times the
pass modes on their main paths' chunks (chip_smoke.py's
``pass_timing_cases``), each with the kernel's own µs a launch from
``torch.profiler`` beside the device and call ms; ``pass_main:NAME``
only the cases whose name holds NAME.  ``flda_double`` also counts, from
``cuobjdump -sass`` of ROOT's built library, the FP64-pipe and MUFU
instructions of each kernel of the float64 mode's resident design.
``ctpf_double`` times ``ctpf_estep``'s float64 mode on the widest
CiteULike bucket against viter and on each narrower bucket at viter 0 and
10, with its launch shape (``double_shape``, where ROOT has it) and the
FP64-pipe and MUFU counts of its float64 kernels' SASS.
``lda_double`` times ``lda_estep``'s float64 mode like ``lda`` (the
widest NSF bucket and the L = 1024 chunk, cast to float64, viter 0-10),
then the widest bucket's first 132, 264 and 528 documents (one and two
documents an SM, two waves) at viter 0 and 10, with its launch shape
(``double_shape``, where ROOT has it) and the FP64-pipe and MUFU counts
of its float64 kernels' SASS.
``scatter_double`` times ``scatter_rows`` in float64 and float32 beside
``index_add_`` on DTM's two first-chunk plans at the mac shape (a
stand-in with the real chunk's run lengths, ``dtm_scatter_standin``,
which prints them) and on the widest NSF chunk at W = 100 and 101.  Prints
one JSON line tagged LABEL with the device and call ms of each (shape,
viter), and appends it to ``chiprun_out/estep_sweep.jsonl``.  The kernel
defaults to ``lda``.  Needs one CUDA GPU.
"""
import importlib.util
import json
import pathlib
import sys

VITERS = (0, 1, 2, 5, 10)
PASS_L, PASS_K = (64, 128, 512, 1024), (25, 100, 300)


def main(root: str, label: str, kernel: str = "lda") -> int:
    here = pathlib.Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(pathlib.Path(root).resolve()))
    spec = importlib.util.spec_from_file_location("chip_smoke_timer", here / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    import numpy as np
    import torch

    import topicmodelsvb_jl_torch as tt
    from topicmodelsvb_jl_torch.kernels.ctpf_estep import ctpf_estep
    from topicmodelsvb_jl_torch.kernels.flda_estep import flda_estep
    from topicmodelsvb_jl_torch.kernels.lda_elbo import lda_elbo_tok
    from topicmodelsvb_jl_torch.kernels.lda_estep import lda_estep
    from topicmodelsvb_jl_torch.utils.numerics import EPSILON, dirichlet_ones

    if not torch.cuda.is_available():
        print("estep_sweep: no CUDA device", file=sys.stderr)
        return 2
    kernel, _, only = kernel.partition(":")
    if kernel not in ("lda", "lda_double", "flda", "flda_double", "ctpf", "ctpf_double", "elbo",
                      "hmtm",
                      "lda_pass", "flda_pass", "ctpf_pass", "pass_main", "scatter_double"):
        raise SystemExit(f"estep_sweep: no kernel {kernel!r}")
    dev = torch.device("cuda", 0)
    packed = tt.synth_packed_nsf_scale(seed=7)
    s0 = tt.bucketize_packed(packed, chunk=1024, pad_multiple=8).segments[0]
    V, K = packed.V, 100
    put = lambda a, dt: torch.as_tensor(np.ascontiguousarray(a), dtype=dt).to(dev)
    out = {"label": label, "kernel": kernel, "card": torch.cuda.get_device_name(0)}
    if kernel in ("lda_pass", "flda_pass"):
        return emit(here, pass_sweep(smoke, kernel, s0, V, dev, out))
    if kernel == "ctpf_pass":
        return emit(here, ctpf_pass_sweep(smoke, V, dev, out))
    if kernel == "scatter_double":
        return emit(here, scatter_sweep(smoke, s0, dev, out))
    if kernel == "pass_main":
        from torch.profiler import ProfilerActivity, profile

        for name, (fn, args) in smoke.pass_timing_cases(dev).items():
            if only not in name:
                continue
            ms, call = smoke.time_calls(lambda: fn(*args))
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(20):
                    fn(*args)
                torch.cuda.synchronize()
            us = sum(e.device_time_total for e in prof.key_averages() if "pass" in e.key) / 20
            out[name] = {"ms": ms, "call_ms": call, "kernel_us": us}
        return emit(here, out)
    if kernel == "hmtm":
        from topicmodelsvb_jl_torch.kernels.hmtm_estep import hmtm_estep, hmtm_logz

        bucketed = tt.bucketize_packed(packed, chunk=1024, pad_multiple=8)
        chunks = smoke.hmtm_chunks(bucketed, V, dev)
        for label_, Kh, _, _, args in chunks[:3]:
            for viter in VITERS:
                out[f"{label_} viter={viter}"] = list(smoke.time_calls(
                    lambda: hmtm_estep(*args, viter=viter, vtol=1.0 / Kh**2)))
            out[f"{label_} logz"] = list(smoke.time_calls(
                lambda: hmtm_logz(*args[:3], args[6], args[7])))
        # the special chunk and the widest chunk in float64, then past the
        # shared-memory modes: (label, K, viters, arguments, calls, reps)
        f64 = tuple(a.double() if a.is_floating_point() else a for a in chunks[0][4])
        wide = lambda Kw, dt: smoke.hmtm_wide_args(Kw, 64, 48, V, dev, Kw, dt)
        for label_, Kh, viters, args, n, reps in (
                (chunks[3][0], 25, (10,), chunks[3][4], 20, 3),
                (f"{chunks[0][0]} float64", 25, (10,), f64, 20, 3),
                ("K=300 B=64 L=48", 300, (3,), wide(300, torch.float32), 20, 3),
                ("K=300 B=64 L=48 float64", 300, (3,), wide(300, torch.float64), 20, 3),
                ("K=170 B=64 L=48 float64", 170, (3,), wide(170, torch.float64), 5, 2),
                (f"K=300 {chunks[0][0]}", 300, (10, 0), smoke.hmtm_k300_chunk(bucketed, V, dev),
                 5, 2)):
            for viter in viters:
                out[f"{label_} viter={viter}"] = list(smoke.time_calls(
                    lambda: hmtm_estep(*args, viter=viter, vtol=1.0 / Kh**2), n, reps))
            out[f"{label_} logz"] = list(smoke.time_calls(
                lambda: hmtm_logz(*args[:3], args[6], args[7]), min(2 * n, 20), reps))
        return emit(here, out)
    if kernel == "ctpf_double":
        return emit(here, ctpf_double_sweep(smoke, dev, out))
    if kernel == "ctpf":
        cpk, cbk, _ = smoke.citeulike()
        lc = smoke.long_chunks(V, cpk.U, dev)
        c0 = cbk.segments[0]
        cases = {f"L={c0.L} R={cpk.Rmax}": smoke.ctpf_args(*smoke.ctpf_bucket(cpk, cbk, dev),
                                                           cpk.V, cpk.U, K, dev),
                 "L=768 R=256": smoke.ctpf_args(*lc["ctpf_long"], V, cpk.U, K, dev)}
        for name, (args, kw) in cases.items():
            for viter in VITERS:
                kw = dict(kw, viter=viter)
                out[f"{name} viter={viter}"] = list(smoke.time_calls(
                    lambda: ctpf_estep(*args, **kw)))
        # the narrower buckets, each at no pass and at 10
        for j, seg in enumerate(cbk.segments[1:], 1):
            args, kw = smoke.ctpf_args(*smoke.ctpf_bucket(cpk, cbk, dev, j), cpk.V, cpk.U, K, dev)
            for viter in (0, 10):
                kw = dict(kw, viter=viter)
                out[f"L={seg.L} R={cpk.Rmax} viter={viter}"] = list(smoke.time_calls(
                    lambda: ctpf_estep(*args, **kw)))
        return emit(here, out)
    chunks = {f"L={s0.L}": (put(s0.terms[:1024], torch.int32), put(s0.counts[:1024], torch.float32),
                            put(s0.doc_mask[:1024], torch.float32)),
              "L=1024": smoke.long_chunks(V, 1, dev)["long"]}
    if kernel == "lda_double":
        from topicmodelsvb_jl_torch.kernels import lda_estep as lda_mod

        if hasattr(lda_mod, "double_shape"):
            out["shape"] = {name: lda_mod.double_shape(seg[0].shape[1], K)
                            for name, seg in chunks.items()}
        out["sass"] = {**sass_counts("16lda_estep_kernelIdLb0E"),
                       **sass_counts("20lda_estep_res_kernel")}
    if kernel == "flda_double":
        w = chunks[f"L={s0.L}"]
        chunks["L=64"] = (w[0][:, :64].contiguous(), w[1][:, :64].contiguous(), w[2])
        out["sass"] = sass_counts("flda_estep_res_kernel")
    if kernel == "elbo":
        s2 = tt.bucketize_packed(packed, chunk=2048, pad_multiple=8).segments[0]
        chunks["K=50 B=2048"] = (put(s2.terms[:2048], torch.int32),
                                 put(s2.counts[:2048], torch.float32),
                                 put(s2.doc_mask[:2048], torch.float32))
        for name, (terms, counts, doc_mask) in chunks.items():
            Kc = 50 if name.startswith("K=50") else K
            g = torch.Generator().manual_seed(11)
            beta = dirichlet_ones(g, V, (Kc,)).to(dev)
            boT = (dirichlet_ones(g, V, (Kc,)).to(dev) + EPSILON).T.contiguous()
            g2T = (boT * (torch.log(beta + EPSILON).T - torch.log(boT))).contiguous()
            _, _, El, El_old = smoke.warm_state(Kc, terms.shape[0], dev, seed=12)
            args = (boT, g2T, terms, counts, doc_mask, El, El_old)
            out[name] = list(smoke.time_calls(lambda: lda_elbo_tok(*args)))
        return emit(here, out)
    for name, (terms, counts, doc_mask) in chunks.items():
        B, L = terms.shape
        if kernel in ("lda", "lda_double"):
            g = torch.Generator().manual_seed(11)
            betaT = (dirichlet_ones(g, V, (K,)).to(dev) + EPSILON).T.contiguous()
            args = (betaT, terms, counts, doc_mask, *smoke.warm_state(K, B, dev, seed=12))
            if kernel == "lda_double":
                args = tuple(a.double() if a.is_floating_point() else a for a in args)
            fn = lda_estep
        else:
            g = torch.Generator().manual_seed(21)
            logbetaT = torch.log(dirichlet_ones(g, V, (K,)) + EPSILON).T.contiguous().to(dev)
            kappa = dirichlet_ones(g, V).to(dev)
            tau, tau_old = ((0.1 + 0.8 * torch.rand(B, L, generator=g)).to(dev) for _ in range(2))
            alpha, gamma, El, El_old = smoke.warm_state(K, B, dev, seed=22)
            args = (logbetaT, kappa, terms, counts, doc_mask, alpha,
                    torch.tensor(0.6, device=dev), gamma, El, El_old, tau, tau_old)
            if kernel == "flda_double":
                args = tuple(a.double() if a.is_floating_point() else a for a in args)
            fn = flda_estep
        for viter in VITERS:
            ms, call = smoke.time_calls(lambda: fn(*args, viter=viter, vtol=1.0 / K**2))
            out[f"{name} viter={viter}"] = [ms, call]
        if kernel == "lda_double" and L == s0.L:
            for nd in (132, 264, 528):
                part = tuple(a[:nd] if a.dim() and a.shape[0] == B else a for a in args)
                for viter in (0, 10):
                    out[f"{name} B={nd} viter={viter}"] = list(smoke.time_calls(
                        lambda: fn(*part, viter=viter, vtol=1.0 / K**2)))
    return emit(here, out)


def pass_sweep(smoke, kernel, s0, V, dev, out) -> dict:
    """The pass mode's device and call ms, its warp mode's shape and ns a
    slot at each (L, K) of PASS_L x PASS_K in float32, and at K = 100 in
    float64 (module doc)."""
    import numpy as np
    import torch

    from topicmodelsvb_jl_torch.kernels import flda_estep, lda_estep

    lda = kernel == "lda_pass"
    fn = lda_estep.lda_estep_pass if lda else flda_estep.flda_estep_pass
    # (lanes a slot, vectors a lane, warps a document); None in a checkout
    # from before the pass modes' warp mode
    shape = getattr(lda_estep if lda else flda_estep, "pass_shape", lambda L, K, dt: None)

    put = lambda a, dt: torch.as_tensor(np.ascontiguousarray(a), dtype=dt).to(dev)
    wide = (put(s0.terms[:1024], torch.int32), put(s0.counts[:1024], torch.float32),
            put(s0.doc_mask[:1024], torch.float32))
    long_ = smoke.long_chunks(V, 1, dev)["long_pad"]
    for L in PASS_L:
        src = wide if L <= wide[0].shape[1] else long_
        seg = tuple(a[:, :L].contiguous() for a in src[:2]) + (src[2],)
        kept = int((seg[1] > 0).sum())
        live = int((seg[2] > 0).sum()) * L
        for K, dt in [(K, torch.float32) for K in PASS_K] + [(100, torch.float64)]:
            segd = (seg[0], seg[1].to(dt), seg[2].to(dt))
            if lda:
                args, n = smoke.pass_args(segd, V, K, dev), kept
            else:
                args, n = smoke.flda_pass_args(segd, V, K, dev)[0], live
            ms, call = smoke.time_calls(lambda: fn(*args))
            tag = f"L={L} K={K}" + (" float64" if dt == torch.float64 else "")
            out[tag] = {"ms": ms, "call_ms": call, "shape": shape(L, K, dt),
                        "ns_a_slot": ms * 1e6 / max(n, 1)}
    return out


def ctpf_pass_sweep(smoke, V, dev, out) -> dict:
    """``ctpf_estep_pass``'s device and call ms, its warp mode's shape and
    ns a kept slot at each (L, R) and K of the module doc."""
    import torch

    from topicmodelsvb_jl_torch.kernels import ctpf_estep

    # (lanes a slot, vectors a lane, warps a document); None in a checkout
    # from before the CTPF pass mode's warp mode
    shape = getattr(ctpf_estep, "pass_shape", lambda L, R, K, dt: None)
    cpk, cbk, _ = smoke.citeulike()
    (tt_, tc, tm), (tr, tq) = smoke.ctpf_bucket(cpk, cbk, dev)
    (lt, lc_, lm), (lr, lq) = smoke.long_chunks(V, cpk.U, dev)["ctpf_long"]
    cut = lambda a, n: a[:, :n].contiguous()
    chunks = {(L, R): ((cut(tt_, L), cut(tc, L), tm), (cut(tr, R), cut(tq, R)), cpk.V)
              for L, R in ((32, 8), (64, 12), (tt_.shape[1], tr.shape[1]))}
    for L, R in ((384, 128), (lt.shape[1], lr.shape[1])):
        chunks[(L, R)] = ((cut(lt, L), cut(lc_, L), lm), (cut(lr, R), cut(lq, R)), V)
    for (L, R), (tok, rd, Vc) in chunks.items():
        kept = int((tok[1] > 0).sum()) + int((rd[1] > 0).sum())
        for K, dt in [(K, torch.float32) for K in PASS_K] + [(100, torch.float64)]:
            args, _ = smoke.ctpf_args(tok, rd, Vc, cpk.U, K, dev)
            args = tuple(a.to(dt) if a.is_floating_point() else a for a in args)
            pargs = (*args[:10], args[10], args[12])
            ms, call = smoke.time_calls(lambda: ctpf_estep.ctpf_estep_pass(*pargs))
            tag = f"L={L} R={R} K={K}" + (" float64" if dt == torch.float64 else "")
            out[tag] = {"ms": ms, "call_ms": call, "shape": shape(L, R, K, dt),
                        "ns_a_slot": ms * 1e6 / max(kept, 1)}
    return out


def ctpf_double_sweep(smoke, dev, out) -> dict:
    """``ctpf_estep``'s float64 mode on the CiteULike corpus's widest
    bucket (chip_smoke.py's ``ctpf_args`` cast to float64) at each viter
    of VITERS, then the first chunk of each narrower bucket at viter 0 and
    10; its launch shape where the package has ``double_shape``; and the
    FP64-pipe and MUFU instruction counts of the float64 kernels' SASS."""
    from topicmodelsvb_jl_torch.kernels import ctpf_estep as mod

    d = lambda args: tuple(a.double() if a.is_floating_point() else a for a in args)
    cpk, cbk, _ = smoke.citeulike()
    for j in range(len(cbk.segments)):
        tok, rd = smoke.ctpf_bucket(cpk, cbk, dev, j)
        args, kw = smoke.ctpf_args(tok, rd, cpk.V, cpk.U, 100, dev)
        args = d(args)
        L, R = tok[0].shape[1], rd[0].shape[1]
        if hasattr(mod, "double_shape"):
            out[f"L={L} R={R} shape"] = mod.double_shape(L, R, 100)
        for viter in (VITERS if j == 0 else (0, 10)):
            kw = dict(kw, viter=viter)
            out[f"L={L} R={R} viter={viter}"] = list(smoke.time_calls(
                lambda: mod.ctpf_estep(*args, **kw)))
    out["sass"] = {**sass_counts("ctpf_estep_kernelIdE"), **sass_counts("ctpf_estep_res_kernel")}
    return out


def scatter_sweep(smoke, s0, dev, out) -> dict:
    """``scatter_rows`` in float64 and float32 beside ``index_add_`` (the
    same sums over all rows) on DTM's two first-chunk plans at the mac
    shape (chip_smoke.py's ``dtm_scatter_standin``) and on the widest NSF
    chunk's token rows at W = 100 and 101 (LDA's and fLDA's), each with
    random weights that are 0 off the kept slots: device and call ms."""
    import numpy as np
    import torch

    from topicmodelsvb_jl_torch.kernels.scatter_rows import build_plan, scatter_rows

    cases = {name: (ids, keep, W) for name, (ids, keep, W) in smoke.dtm_scatter_standin().items()}
    for W in (100, 101):
        cases[f"NSF widest chunk W={W}"] = (s0.terms[:1024], s0.counts[:1024] > 0, W)
    g = np.random.default_rng(3)
    for name, (ids, keep, W) in cases.items():
        ids, keep = np.asarray(ids).reshape(-1), np.asarray(keep).reshape(-1)
        plan = build_plan(ids, keep).to(dev)
        V = int(ids.max()) + 1
        ids_l = torch.as_tensor(ids, dtype=torch.long, device=dev)
        for dt in (torch.float64, torch.float32):
            w = torch.as_tensor(g.random((ids.size, W)) * keep[:, None], dtype=dt, device=dev)
            acc = torch.zeros((V, W), dtype=dt, device=dev)
            tag = f"{name} {'float64' if dt == torch.float64 else 'float32'}"
            out[tag] = {"ms": list(smoke.time_calls(lambda: scatter_rows(acc, w, plan))),
                        "index_add_ms": list(smoke.time_calls(
                            lambda: acc.index_add_(0, ids_l, w)))}
        out[f"{name} plan"] = {"kept": int(plan.rows.shape[0]), "pieces": plan.n_pieces,
                               "split_runs": int(plan.run_id.shape[0])}
    return out


def sass_counts(pattern: str) -> dict:
    """Each kernel of the built library whose mangled name holds
    ``pattern``: its FP64-pipe (DFMA, DADD, DMUL, DMNMX, DSETP) and MUFU
    instructions in the SASS (``cuobjdump -sass``), static counts."""
    import collections
    import re
    import subprocess

    from topicmodelsvb_jl_torch.kernels import _build

    lib = _build.build()
    tool = pathlib.Path(_build._nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    keep = ("DFMA", "DADD", "DMUL", "DMNMX", "DSETP", "MUFU")
    out, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = m.group(1) if pattern in m.group(1) else None
            if cur:
                out[cur] = collections.Counter()
            continue
        op = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9]*)", line)
        if cur and op and op.group(1) in keep:
            out[cur][op.group(1)] += 1
    return {name: dict(c) for name, c in out.items()}


def emit(here, out) -> int:
    """Print the JSON line and append it to chiprun_out/estep_sweep.jsonl."""
    line = json.dumps(out)
    print(line)
    dest = here / "chiprun_out"
    dest.mkdir(exist_ok=True)
    with open(dest / "estep_sweep.jsonl", "a") as f:
        f.write(line + "\n")
    return 0


if __name__ == "__main__":
    if len(sys.argv) not in (3, 4):
        raise SystemExit(__doc__)
    sys.exit(main(*sys.argv[1:]))
