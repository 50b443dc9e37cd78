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
1024-document chunks: one warm-up iteration each, then three steps alone,
each timed by the host clock up to a synchronize.  Last, ``digests``:
a sha256 of the outputs of the E-step kernels, their pass modes,
``lda_elbo_tok``, ``scatter_rows``, ``hmtm_estep`` and ``hmtm_logz`` (f32,
and the f64 Elogtheta modes of ``lda_estep`` and ``flda_estep``; phase 3's
and phase 9's arguments) on the widest NSF and CiteULike chunks and on
the chunks whose rows do not fit shared memory; equal digests from two
checkouts mean the kernels give the same bits.  ROOT's package must have
those modes.
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
    cpk = kc["cpk"]
    cbk = tt.bucketize_packed(cpk, chunk=1024, pad_multiple=8)
    for tag, (tok, rd, Vc) in (("wide", (*smoke.ctpf_bucket(cpk, cbk, dev), cpk.V)),
                               ("long", (*lc["ctpf_long"], V))):
        cargs, ckw = smoke.ctpf_args(tok, rd, Vc, cpk.U, K, dev)
        outs[f"ctpf_estep_{tag}"] = ctpf_estep(*cargs, **ckw)
        outs[f"ctpf_estep_pass_{tag}"] = ctpf_estep_pass(*cargs[:10], cargs[10], cargs[12])
    for label, Kh, viter, _, hargs in smoke.hmtm_chunks(kc["bucketed"], V, dev):
        if hargs[1].shape[1] > 1024:
            continue
        tag = f"K{Kh}_L{hargs[1].shape[1]}"
        outs[f"hmtm_estep_{tag}"] = hmtm_estep(*hargs, viter=viter, vtol=1.0 / Kh**2)
        got = outs[f"hmtm_estep_{tag}"]
        outs[f"hmtm_logz_{tag}"] = (hmtm_logz(*hargs[:3], got[0], got[1]),)
    torch.cuda.synchronize()
    return {name: hashlib.sha256(b"".join(t.cpu().numpy().tobytes() for t in o)).hexdigest()[:16]
            for name, o in outs.items()}


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
