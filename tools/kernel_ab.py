"""Time the port's five kernels at chip_smoke.py's shapes, from the package
of another checkout, with this checkout's timer.

    python3 tools/kernel_ab.py ROOT LABEL

ROOT holds a checkout of this repository: ``.`` for this one, or a
``git archive`` of another commit unpacked into a directory that
``.gitignore`` lists.  ROOT's ``topicmodelsvb_jl_torch`` is imported and
built; the corpora, shapes, checks and timer are those of THIS checkout's
``chip_smoke.py`` (``kernel_checks``): each kernel against its plain
version, its device time over many launches, its call time and its bound,
and the scatter beside ``index_add_``.  Then the LDA and fLDA main paths
(NSF scale) and the CTPF main path (CiteULike scale), K = 100,
1024-document chunks, and HMTM's (NSF with unit counts, K = 25): one
warm-up iteration each, then three steps alone, each timed by the host
clock up to a synchronize.  Then ``pass_ms``: the device and call ms of
the pass modes of ``lda_estep``, ``flda_estep`` and ``ctpf_estep`` on
their main paths' chunks (chip_smoke.py's ``pass_timing_cases``), and
``flda_double_ms`` and ``lda_double_ms``: ``flda_estep``'s and
``lda_estep``'s float64 modes on the widest NSF chunk and the L = 1024
one, and ``lda_f64_ms`` ``lda_estep``'s f64 Elogtheta channel on them;
``ctpf_double_ms``: ``ctpf_estep``'s float64 mode on
the widest CiteULike bucket; ``scatter_double_ms``: ``scatter_rows``'s
float64 mode on DTM's two first-chunk plans at the mac shape
(chip_smoke.py's ``dtm_scatter_standin``, which prints their run lengths)
and on the widest NSF chunk's rows at W = 100, each with ``index_add_``
beside it.  Last, ``digests``: a sha256 of the outputs of the
E-step kernels, their pass modes, ``lda_elbo_tok``, ``scatter_rows``,
``hmtm_estep`` and ``hmtm_logz`` (f32, and the f64 Elogtheta modes of
``lda_estep`` and ``flda_estep``, the float64 modes of the three pass
modes and of ``flda_estep``; phase 3's
and phase 9's arguments) on the widest NSF and CiteULike chunks and on
the chunks whose rows do not fit shared memory, and of ``hmtm_estep`` and
``hmtm_logz`` at K = 300 (``hmtm_cases``: the widest NSF chunk in f32,
whose device and call ms are timed too, and a float64 chunk), of
``scatter_rows`` in both dtypes on DTM's two stand-in plans and in
float64 on the widest NSF chunk, of ``ctpf_estep``'s float64 mode on the
widest CiteULike bucket and of ``lda_estep``'s on the widest NSF chunk
and the L = 1024 one; equal
digests from two checkouts mean the kernels give the same bits.  ROOT's
package must have those modes.
Prints one JSON line tagged LABEL and appends it to
``chiprun_out/kernel_ab.jsonl``.  To compare two commits, run both in one
call on one card, in turns: parent, change, change, parent.  Needs one
CUDA GPU.
"""
import hashlib
import importlib.util
import json
import pathlib
import subprocess
import sys
import time


def hmtm_cases(smoke, kc, dev) -> list:
    """HMTM's chunks, each (tag, K, viter, hmtm_estep's arguments): phase
    9's but the L = 4,096 one, then past the shared-memory modes the widest
    NSF chunk at K = 300 in float32 (``hmtm_k300_chunk``, viter 10) and a
    ``hmtm_wide_args`` chunk at K = 300 in float64 (64 documents of L =
    48, viter 3)."""
    import torch

    out = [(f"K{Kh}_L{a[1].shape[1]}", Kh, viter, a)
           for _, Kh, viter, _, a in smoke.hmtm_chunks(kc["bucketed"], kc["V"], dev)
           if a[1].shape[1] <= 1024]
    k300 = smoke.hmtm_k300_chunk(kc["bucketed"], kc["V"], dev)
    out.append((f"K300_L{k300[1].shape[1]}", 300, 10, k300))
    out.append(("K300_f64_L48", 300, 3,
                smoke.hmtm_wide_args(300, 64, 48, kc["V"], dev, 300, torch.float64)))
    return out


def digests(smoke, kc, dev) -> dict:
    """sha256 (16 hex digits) of each kernel's outputs at chip_smoke.py's
    arguments: the widest NSF chunk, the L = 1024 chunk (rows in tiles)
    and, for ``ctpf_estep`` and its pass mode, the widest CiteULike chunk
    and the L = 768, R = 256 chunk; for ``hmtm_estep``/``hmtm_logz``,
    phase 9's chunks but the L = 4,096 one."""
    import numpy as np
    import torch

    import topicmodelsvb_jl_torch as tt
    from topicmodelsvb_jl_torch.kernels.ctpf_estep import ctpf_estep, ctpf_estep_pass
    from topicmodelsvb_jl_torch.kernels.flda_estep import flda_estep, flda_estep_pass
    from topicmodelsvb_jl_torch.kernels.hmtm_estep import hmtm_estep, hmtm_logz
    from topicmodelsvb_jl_torch.kernels.lda_elbo import lda_elbo_tok
    from topicmodelsvb_jl_torch.kernels.lda_estep import lda_estep, lda_estep_pass
    from topicmodelsvb_jl_torch.kernels.scatter_rows import build_plan, scatter_rows
    from topicmodelsvb_jl_torch.utils.numerics import EPSILON

    K, V = kc["K"], kc["V"]
    put = lambda a, dt: torch.as_tensor(np.ascontiguousarray(a), dtype=dt).to(dev)
    s0 = kc["bucketed"].segments[0]
    wide = (put(s0.terms[:1024], torch.int32), put(s0.counts[:1024], torch.float32),
            put(s0.doc_mask[:1024], torch.float32))
    lc = smoke.long_chunks(V, kc["cpk"].U, dev)
    kw = dict(viter=10, vtol=1.0 / K**2)
    outs = {}
    for tag, seg in (("wide", wide), ("long", lc["long_pad"])):
        args, beta, beta_old = smoke.lda_args(seg, V, K, dev)
        outs[f"lda_estep_{tag}"] = lda_estep(*args, **kw)
        plan = build_plan(seg[0].cpu().numpy(), (seg[1] > 0).cpu().numpy()).to(dev)
        acc = torch.zeros((V, K), device=dev)
        outs[f"scatter_rows_{tag}"] = (scatter_rows(acc, outs[f"lda_estep_{tag}"][3]
                                                    .reshape(-1, K), plan),)
        boT = (beta_old + EPSILON).T.contiguous()
        g2T = (boT * (torch.log(beta + EPSILON).T - torch.log(boT))).contiguous()
        outs[f"lda_elbo_tok_{tag}"] = (lda_elbo_tok(boT, g2T, *seg, args[6], args[7]),)
        outs[f"flda_estep_{tag}"] = flda_estep(*smoke.flda_args(seg, V, K, dev), **kw)
        outs[f"lda_estep_f64_{tag}"] = lda_estep(*args, **kw, elogtheta_f64=True)
        outs[f"flda_estep_f64_{tag}"] = flda_estep(*smoke.flda_args(seg, V, K, dev), **kw,
                                                   elogtheta_f64=True)
        outs[f"lda_estep_pass_{tag}"] = (lda_estep_pass(args[0], *seg, args[6]),)
        fa = smoke.flda_args(seg, V, K, dev)
        outs[f"flda_estep_pass_{tag}"] = flda_estep_pass(*fa[:5], fa[6], fa[8], fa[10])
        d = lambda *a: tuple(x.double() if x.is_floating_point() else x for x in a)
        outs[f"lda_estep_pass_double_{tag}"] = (lda_estep_pass(*d(args[0], *seg, args[6])),)
        outs[f"flda_estep_pass_double_{tag}"] = flda_estep_pass(
            *d(*fa[:5], fa[6], fa[8], fa[10]))
        outs[f"flda_estep_double_{tag}"] = flda_estep(*d(*fa), **kw)
    cpk = kc["cpk"]
    cbk = tt.bucketize_packed(cpk, chunk=1024, pad_multiple=8)
    for tag, (tok, rd, Vc) in (("wide", (*smoke.ctpf_bucket(cpk, cbk, dev), cpk.V)),
                               ("long", (*lc["ctpf_long"], V))):
        cargs, ckw = smoke.ctpf_args(tok, rd, Vc, cpk.U, K, dev)
        outs[f"ctpf_estep_{tag}"] = ctpf_estep(*cargs, **ckw)
        outs[f"ctpf_estep_pass_{tag}"] = ctpf_estep_pass(*cargs[:10], cargs[10], cargs[12])
        c64 = tuple(a.double() if a.is_floating_point() else a for a in cargs)
        outs[f"ctpf_estep_pass_double_{tag}"] = ctpf_estep_pass(*c64[:10], c64[10], c64[12])
        if tag == "wide":
            outs["ctpf_estep_double_wide"] = ctpf_estep(*c64, **ckw)
    d64 = lambda a: tuple(x.double() if x.is_floating_point() else x for x in a)
    for tag, seg in (("wide", wide), ("long", lc["long_pad"])):
        largs = d64(smoke.lda_args(seg, V, K, dev)[0])
        outs[f"lda_estep_double_{tag}"] = lda_estep(*largs, **kw)
    for name, (plan, w, n_rows, _) in scatter_cases(smoke, kc, dev, torch.float64).items():
        acc = torch.zeros((n_rows, w.shape[1]), dtype=w.dtype, device=dev)
        outs[f"scatter_rows_double_{name}"] = (scatter_rows(acc, w, plan),)
    for name, (plan, w, n_rows, _) in scatter_cases(smoke, kc, dev, torch.float32,
                                                    ("dtm_A", "dtm_slice")).items():
        acc = torch.zeros((n_rows, w.shape[1]), dtype=w.dtype, device=dev)
        outs[f"scatter_rows_{name}"] = (scatter_rows(acc, w, plan),)
    for tag, Kh, viter, hargs in hmtm_cases(smoke, kc, dev):
        outs[f"hmtm_estep_{tag}"] = hmtm_estep(*hargs, viter=viter, vtol=1.0 / Kh**2)
        got = outs[f"hmtm_estep_{tag}"]
        outs[f"hmtm_logz_{tag}"] = (hmtm_logz(*hargs[:3], got[0], got[1]),)
    torch.cuda.synchronize()
    return {name: hashlib.sha256(b"".join(t.cpu().numpy().tobytes() for t in o)).hexdigest()[:16]
            for name, o in outs.items()}


def scatter_cases(smoke, kc, dev, dtype, names=("dtm_A", "dtm_slice", "wide")) -> dict:
    """``scatter_rows``'s chunks, each name -> (plan on ``dev``, weights
    [T, W] in ``dtype``, acc rows, ids as int64): DTM's A rows (W = 20) and
    per-slice rows (W = 41) from chip_smoke.py's ``dtm_scatter_standin``,
    and the widest NSF chunk's token rows (W = 100); the weights seeded
    uniforms, 0 off the kept slots."""
    import numpy as np
    import torch

    from topicmodelsvb_jl_torch.kernels.scatter_rows import build_plan

    src = {}
    if "dtm_A" in names or "dtm_slice" in names:
        dtm = smoke.dtm_scatter_standin()
        src["dtm_A"], src["dtm_slice"] = dtm["A rows"], dtm["per-slice rows"]
    s0 = kc["bucketed"].segments[0]
    src["wide"] = (s0.terms[:1024], s0.counts[:1024] > 0, 100)
    out = {}
    for j, name in enumerate(names):
        ids, keep, W = src[name]
        ids, keep = np.asarray(ids).reshape(-1), np.asarray(keep).reshape(-1)
        g = torch.Generator().manual_seed(31 + j)
        w = (torch.rand((ids.size, W), generator=g, dtype=torch.float64)
             * torch.from_numpy(keep)[:, None]).to(dtype).to(dev)
        out[name] = (build_plan(ids, keep).to(dev), w, int(ids.max()) + 1,
                     torch.as_tensor(ids, dtype=torch.long, device=dev))
    return out


def scatter_double_ms(smoke, kc, dev) -> dict:
    """Device and call ms of ``scatter_rows``'s float64 mode on
    ``scatter_cases``, each with ``index_add_`` over all rows beside it."""
    import torch

    from topicmodelsvb_jl_torch.kernels.scatter_rows import scatter_rows

    out = {}
    for name, (plan, w, n_rows, ids) in scatter_cases(smoke, kc, dev, torch.float64).items():
        acc = torch.zeros((n_rows, w.shape[1]), dtype=w.dtype, device=dev)
        out[name] = {"ms": list(smoke.time_calls(lambda: scatter_rows(acc, w, plan))),
                     "index_add_ms": list(smoke.time_calls(lambda: acc.index_add_(0, ids, w)))}
    return out


def ctpf_double_ms(smoke, kc, dev) -> list:
    """Device and call ms of ``ctpf_estep``'s float64 mode (viter 10) on
    the widest CiteULike bucket, ``ctpf_args`` cast to float64."""
    import topicmodelsvb_jl_torch as tt
    from topicmodelsvb_jl_torch.kernels.ctpf_estep import ctpf_estep

    cpk = kc["cpk"]
    cbk = tt.bucketize_packed(cpk, chunk=1024, pad_multiple=8)
    args, kw = smoke.ctpf_args(*smoke.ctpf_bucket(cpk, cbk, dev), cpk.V, cpk.U, kc["K"], dev)
    args = tuple(a.double() if a.is_floating_point() else a for a in args)
    return list(smoke.time_calls(lambda: ctpf_estep(*args, **kw)))


def double_ms(smoke, kc, dev, family) -> dict:
    """Device and call ms of ``flda_estep``'s (``family`` "flda") or
    ``lda_estep``'s ("lda") float64 mode (viter 10) on phase 3's arguments
    cast to float64, or of ``lda_estep``'s f64 Elogtheta channel on them in
    float32 ("lda_f64"): the widest NSF chunk and the L = 1024 chunk."""
    import numpy as np
    import torch

    from topicmodelsvb_jl_torch.kernels.flda_estep import flda_estep
    from topicmodelsvb_jl_torch.kernels.lda_estep import lda_estep

    K, V = kc["K"], kc["V"]
    put = lambda a, dt: torch.as_tensor(np.ascontiguousarray(a), dtype=dt).to(dev)
    s0 = kc["bucketed"].segments[0]
    chunks = {f"L{s0.L}": (put(s0.terms[:1024], torch.int32), put(s0.counts[:1024], torch.float32),
                           put(s0.doc_mask[:1024], torch.float32)),
              "L1024": smoke.long_chunks(V, 1, dev)["long_pad"]}
    fn = flda_estep if family == "flda" else lda_estep
    out = {}
    for tag, seg in chunks.items():
        args = (smoke.flda_args(seg, V, K, dev) if family == "flda"
                else smoke.lda_args(seg, V, K, dev)[0])
        kw = dict(viter=10, vtol=1.0 / K**2)
        if family == "lda_f64":
            kw["elogtheta_f64"] = True
        else:
            args = tuple(a.double() if a.is_floating_point() else a for a in args)
        out[tag] = list(smoke.time_calls(lambda: fn(*args, **kw)))
    return out


def main(root: str, label: str) -> int:
    here = pathlib.Path(__file__).resolve().parents[1]
    root_path = pathlib.Path(root).resolve()
    sys.path.insert(0, str(root_path))
    spec = importlib.util.spec_from_file_location("chip_smoke_timer", here / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    from topicmodelsvb_jl_torch.kernels import _build

    if not pathlib.Path(_build.__file__).resolve().is_relative_to(root_path):
        raise SystemExit(f"kernel_ab: imported {_build.__file__}, not ROOT's package")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip()
    _build.build()
    dev = torch.device("cuda", 0)
    kc = smoke.kernel_checks(dev)
    out = {"label": label, "root": str(root_path), "card": smi,
           **{k: kc[k] for k in ("estep", "elbo", "flda", "ctpf", "scatter")}}
    import topicmodelsvb_jl_torch as tt

    for name, cls, corpus in (("lda", tt.LDA, kc["packed"]), ("flda", tt.fLDA, kc["packed"]),
                              ("ctpf", tt.CTPF, kc["cpk"])):
        m = cls(corpus, 100, tt.RuntimeConfig(chunk_docs=1024), device="cuda", seed=7)
        m.train(iter=1, checkelbo=float("inf"), printelbo=False)
        tr, state, steps = m.trainer, m.state, []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state = tr.step_fn(state, *tr.data)
            torch.cuda.synchronize()
            steps.append(time.perf_counter() - t0)
        out[f"{name}_step_s"] = steps
    # HMTM's main path: NSF with unit counts, K = 25, viter 10
    from topicmodelsvb_jl_torch.ops.packing import unit_counts

    m = tt.HMTM(unit_counts(kc["packed"]), 25, tt.RuntimeConfig(chunk_docs=1024), device="cuda",
                seed=7)
    m.train(iter=1, checkelbo=float("inf"), printelbo=False)
    tr, state, steps = m.trainer, m.state, []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = tr.step_fn(state, *tr.data)
        torch.cuda.synchronize()
        steps.append(time.perf_counter() - t0)
    out["hmtm_step_s"] = steps
    # HMTM past the shared-memory modes: device and call ms of hmtm_estep
    # and hmtm_logz at K = 300 (few calls: the wide mode takes ~0.7 s one)
    from topicmodelsvb_jl_torch.kernels.hmtm_estep import hmtm_estep, hmtm_logz

    for tag, Kh, viter, a in hmtm_cases(smoke, kc, dev)[-2:]:
        kw = dict(viter=viter, vtol=1.0 / Kh**2)
        tg = hmtm_estep(*a, **kw)
        out[f"hmtm_estep_{tag}_ms"] = smoke.time_calls(lambda: hmtm_estep(*a, **kw), 3, 1)
        out[f"hmtm_logz_{tag}_ms"] = smoke.time_calls(
            lambda: hmtm_logz(*a[:3], tg[0], tg[1]), 3, 1)
    out["pass_ms"] = {name: list(smoke.time_calls(lambda: fn(*args)))
                      for name, (fn, args) in smoke.pass_timing_cases(dev, cpk=kc["cpk"]).items()}
    # flda_estep's and lda_estep's float64 modes at the widest NSF chunk and
    # the L = 1024 one
    out["flda_double_ms"] = double_ms(smoke, kc, dev, "flda")
    out["lda_double_ms"] = double_ms(smoke, kc, dev, "lda")
    out["lda_f64_ms"] = double_ms(smoke, kc, dev, "lda_f64")
    out["ctpf_double_ms"] = ctpf_double_ms(smoke, kc, dev)
    out["scatter_double_ms"] = scatter_double_ms(smoke, kc, dev)
    out["digests"] = digests(smoke, kc, dev)
    line = json.dumps(out)
    print(line)
    dest = here / "chiprun_out"
    dest.mkdir(exist_ok=True)
    with open(dest / "kernel_ab.jsonl", "a") as f:
        f.write(line + "\n")
    return 0


if __name__ == "__main__":
    if len(sys.argv) != 3:
        raise SystemExit(__doc__)
    sys.exit(main(sys.argv[1], sys.argv[2]))
