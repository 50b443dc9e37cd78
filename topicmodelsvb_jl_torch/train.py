"""Command-line training entry point.

The reference has no config system: everything is a ``train!`` keyword
argument (LDA.jl:161).  This CLI exposes the same knobs (TrainConfig),
the runtime knobs (RuntimeConfig), model and corpus selection, the JSONL
metrics sink and the profiler, so a training run is reproducible from one
command.  It is the JAX package's CLI (``topicmodelsvb_jl_tpu.train``) on
this package's modules, with the same flags and summary keys and one flag
more, ``--device`` (default ``cuda``; ``cpu`` runs the kernels' plain
versions):

    python -m topicmodelsvb_jl_torch.train --model lda --corpus nsf-scale \\
        --k 100 --iter 10 --checkelbo inf --json

    python -m topicmodelsvb_jl_torch.train --model ctpf --corpus citeu \\
        --k 100 --iter 50 --metrics run.jsonl

    python -m topicmodelsvb_jl_torch.train --model lda --device cpu \\
        --docfile docs.txt --vocabfile vocab.txt --counts --k 9

The last line of output is a JSON summary (always with ``--json``,
otherwise after the reference-format ∆elbo prints).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m topicmodelsvb_jl_torch.train",
        description="Train a topic model (PyTorch and CUDA TopicModelsVB).",
    )
    p.add_argument("--model", required=True,
                   choices=["lda", "flda", "ctm", "fctm", "ctpf", "dtm",
                            "hmtm"])
    p.add_argument("--k", type=int, required=True, help="number of topics")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--device", default="cuda",
                   help="device to train on (default cuda; cpu runs the "
                        "kernels' plain PyTorch versions)")

    # ── corpus selection ──
    c = p.add_argument_group("corpus")
    c.add_argument("--corpus", default=None,
                   choices=["nsf", "citeu", "mac", "synth", "nsf-scale"],
                   help="bundled dataset, 'synth' (generative sampler), or "
                        "'nsf-scale' (fast packed synthetic at NSF scale)")
    c.add_argument("--subset", type=int, default=None,
                   help="truncate the corpus to this many documents")
    c.add_argument("--packed-dir", default=None,
                   help="directory written by ops.packing.save_packed; "
                        "loaded as read-only memmaps (a corpus larger than "
                        "RAM streams from disk)")
    c.add_argument("--trim-packed", action="store_true",
                   help="with --packed-dir: drop vocabulary ids no "
                        "document uses before training (fixcorp's trim "
                        "for packed corpora; the new->old id map is "
                        "saved as <checkpoint-dir|state-dir>/"
                        "vocab_ids.npy when either is set)")
    c.add_argument("--docfile", default="", help="readcorp docfile")
    c.add_argument("--vocabfile", default="")
    c.add_argument("--userfile", default="")
    c.add_argument("--titlefile", default="")
    c.add_argument("--counts", action="store_true")
    c.add_argument("--readers", action="store_true")
    c.add_argument("--ratings", action="store_true")
    c.add_argument("--stamps", action="store_true")
    c.add_argument("--synth-m", type=int, default=1000)
    c.add_argument("--synth-v", type=int, default=500)
    c.add_argument("--synth-u", type=int, default=0)
    c.add_argument("--synth-slices", type=int, default=0)
    c.add_argument("--fixcorp", action="store_true",
                   help="run the reference fixcorp pipeline "
                        "(stop, trim, alphabetize, remove_empty_docs)")

    # ── TrainConfig (reference train! kwargs, LDA.jl:161) ──
    t = p.add_argument_group("training (reference train! kwargs)")
    t.add_argument("--iter", type=int, default=150)
    t.add_argument("--tol", type=float, default=1.0)
    t.add_argument("--niter", type=int, default=1000)
    t.add_argument("--ntol", type=float, default=None)
    t.add_argument("--viter", type=int, default=10)
    t.add_argument("--vtol", type=float, default=None)
    t.add_argument("--checkelbo", default="1",
                   help="positive integer cadence or 'inf'")
    t.add_argument("--quiet", action="store_true", help="printelbo=false")
    t.add_argument("--identify", action="store_true",
                   help="ctm/fctm: gauge-fix the logistic-normal "
                        "(projection normalisation of reference "
                        "todo.txt:25 / issue #14)")
    t.add_argument("--delta", type=float, default=1.0,
                   help="DTM time-slice width")
    t.add_argument("--cgiter", type=int, default=20,
                   help="DTM betahat CG iterations per sweep")

    # ── RuntimeConfig ──
    r = p.add_argument_group("runtime")
    r.add_argument("--chunk-docs", type=int, default=None)
    r.add_argument("--pad-multiple", type=int, default=None)
    r.add_argument("--dtype", default=None, choices=["float32", "float64"],
                   help="float32 or float64, on the card or the CPU, for "
                        "every model")
    r.add_argument("--no-pallas", action="store_true",
                   help="the JAX CLI's switch to its plain E-step: the "
                        "plain versions run on the CPU anyway; on a CUDA "
                        "device, which has no plain path, it is refused")
    r.add_argument("--metrics", default=None, help="JSONL metrics sink path")
    r.add_argument("--profile-dir", default=None,
                   help="torch.profiler Chrome trace of the first steady "
                        "steps, written here")
    r.add_argument("--checkpoint-every", type=int, default=None)
    r.add_argument("--checkpoint-dir", default=None)
    r.add_argument("--checkpoint-f16", action="store_true",
                   help="snapshot per-doc state at f16 (halves the "
                        "async checkpoint's D2H bytes; resume "
                        "re-converges rather than bit-reproducing)")
    r.add_argument("--elogtheta-f64", action="store_true",
                   help="lda/flda: run the per-doc gamma->Elogtheta "
                        "digamma channel in float64 on the float32 state "
                        "(a mode of the E-step kernels)")
    r.add_argument("--n-devices", type=int, default=None,
                   help="the data axis's size: every process of the group "
                        "(one device each)")

    # ── multi-process launch (parallel/multihost) ──
    d = p.add_argument_group("distributed (one process per device)")
    d.add_argument("--coordinator", default=None,
                   help="torch.distributed rendezvous address host:port; "
                        "launch the SAME command on every process (NCCL "
                        "on CUDA, gloo with --device cpu).  With "
                        "--streaming/--online each process streams its own "
                        "rows of every batch (statistics reduce across "
                        "processes per sweep)")
    d.add_argument("--num-processes", type=int, default=None)
    d.add_argument("--process-id", type=int, default=None)

    # ── streaming / online (host-resident corpus; every model) ──
    s = p.add_argument_group("streaming")
    s.add_argument("--streaming", action="store_true",
                   help="host-resident corpus+state, device memory "
                        "O(batch) (Streaming{LDA,FLDA,CTM,FCTM,CTPF,HMTM,"
                        "DTM}; any --model, dtm from a stamped Corpus)")
    s.add_argument("--online", action="store_true",
                   help="per-minibatch SVI-schedule updates (implies "
                        "--streaming); --iter counts epochs")
    s.add_argument("--batch-docs", type=int, default=8192)
    s.add_argument("--state-dir", default=None,
                   help="with --streaming/--online: keep the per-doc "
                        "variational state in writable .npy memmaps under "
                        "this directory instead of RAM")
    s.add_argument("--tau0", type=float, default=64.0)
    s.add_argument("--kappa", type=float, default=0.7)

    p.add_argument("--json", action="store_true",
                   help="suppress prints; emit one JSON summary line")
    p.add_argument("--save", default=None, help="checkpoint path to save to")
    return p


def _build_corpus(args):
    from . import datasets

    if args.packed_dir:
        from .ops.packing import load_packed, trim_packed

        packed = load_packed(args.packed_dir)
        if args.trim_packed:
            import numpy as np

            V0 = packed.V
            packed, used = trim_packed(packed)
            if not args.json:
                print(f"trim_packed: V {V0} -> {packed.V}")
            out = args.checkpoint_dir or args.state_dir
            if out:
                os.makedirs(out, exist_ok=True)
                np.save(os.path.join(out, "vocab_ids.npy"), used)
        return packed
    if args.corpus == "nsf-scale":
        chunk = args.chunk_docs or 1024
        seed = 7 if args.seed is None else args.seed   # explicit 0 honoured
        return datasets.synth_packed_nsf_scale(
            M=args.subset or 128_804, seed=seed, chunk_docs=chunk)
    if args.corpus == "nsf":
        return datasets.load_nsf(subset=args.subset)
    if args.corpus == "citeu":
        return datasets.load_citeu(subset=args.subset)
    if args.corpus == "mac":
        return datasets.load_mac(subset=args.subset)
    if args.corpus == "synth":
        return datasets.synth_corpus(
            M=args.synth_m, V=args.synth_v, U=args.synth_u, K=args.k,
            seed=0 if args.seed is None else args.seed,
            n_slices=args.synth_slices,
            drift=0.05 if args.synth_slices else 0.0)
    if args.docfile or args.vocabfile:
        from .corpus import readcorp

        return readcorp(docfile=args.docfile, vocabfile=args.vocabfile,
                        userfile=args.userfile, titlefile=args.titlefile,
                        counts=args.counts, readers=args.readers,
                        ratings=args.ratings, stamps=args.stamps)
    raise SystemExit("need --corpus, --packed-dir or --docfile/--vocabfile")


def _checkelbo(args) -> float:
    return (float("inf") if str(args.checkelbo).lower() in ("inf", "none")
            else int(args.checkelbo))


# each --model's family, as kernels._build names it
_FAMILY = {"lda": "LDA", "flda": "fLDA", "ctm": "CTM", "fctm": "fCTM", "ctpf": "CTPF",
           "dtm": "DTM", "hmtm": "HMTM"}


def run(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device is available; "
                         "pass --device cpu to run on the CPU")
    if args.no_pallas and device.type == "cuda":
        raise SystemExit("--no-pallas: a CUDA device has no plain E-step path (a CUDA "
                         "tensor launches the hand-written kernel); the plain versions "
                         "run with --device cpu")
    # the state's dtype on this device (kernels._build.check_dtype), before
    # any corpus is built: every family's kernels have float32 and float64
    # modes, so the gate refuses any other dtype
    from .kernels._build import check_dtype

    try:
        check_dtype(_FAMILY[args.model], args.dtype or "float32", device)
    except TypeError as e:
        raise SystemExit(f"--dtype {args.dtype}: {e}") from None

    from . import api
    from .corpus import Corpus, fixcorp
    from .parallel import multihost
    from .parallel.mesh import make_mesh
    from .utils.config import RuntimeConfig

    if args.coordinator or args.num_processes or args.process_id is not None:
        # NCCL on the card, gloo on the CPU
        multihost.initialize(args.coordinator, args.num_processes, args.process_id,
                             backend=None if device.type == "cuda" else "gloo")

    corp = _build_corpus(args)
    if args.fixcorp and isinstance(corp, Corpus):
        fixcorp(corp, stop=True, trim=True, alphabetize=True,
                remove_empty_docs=True)

    if args.model == "hmtm":
        # HMTM consumes terms as an ordered token stream and rejects
        # condensed corpora; every bundled corpus source carries counts,
        # so expand to one entry per token here (repeats adjacent: see
        # corpus.expand_corp on what order survives)
        if isinstance(corp, Corpus):
            from .corpus import expand_corp

            if any(c > 1 for d in corp.docs for c in d.counts):
                if not args.json:
                    print("hmtm: expanding condensed corpus to one entry "
                          "per token (repeats adjacent)")
                expand_corp(corp)
        else:   # packed synthetic (nsf-scale): shape-only benchmark input
            from .ops.packing import unit_counts

            if not args.json:
                print("hmtm: flattening synthetic packed counts to 1 "
                      "(multiplicity is synthetic here; shape-only input)")
            corp = unit_counts(corp)

    rt_kw = {}
    for field, attr in [("chunk_docs", "chunk_docs"),
                        ("pad_multiple", "pad_multiple"),
                        ("dtype", "dtype"),
                        ("metrics_path", "metrics"),
                        ("profile_dir", "profile_dir"),
                        ("checkpoint_every", "checkpoint_every"),
                        ("checkpoint_dir", "checkpoint_dir")]:
        v = getattr(args, attr)
        if v is not None:
            rt_kw[field] = v
    if args.checkpoint_f16:
        rt_kw["checkpoint_f16"] = True
    if args.elogtheta_f64:
        rt_kw["elogtheta_f64"] = True
    runtime = RuntimeConfig(**rt_kw)
    # Several processes streaming take a local mesh: each process sweeps
    # its own rows of every batch on its own device, and the streaming
    # models reduce over the process group themselves
    local_mesh = (args.streaming or args.online) and multihost.process_count() > 1
    mesh = (make_mesh(n_devices=args.n_devices, axis_names=(runtime.data_axis,),
                      local=local_mesh)
            if args.n_devices else None)

    if args.state_dir and not (args.streaming or args.online):
        raise SystemExit("--state-dir only applies with --streaming/--online")
    if args.streaming or args.online:
        if args.metrics or args.profile_dir:
            raise SystemExit(
                "--metrics/--profile-dir are not supported with "
                "--streaming/--online (the streaming driver has no "
                "JSONL metrics sink)")
        return _run_streaming(args, corp, runtime, mesh)

    cls = {"lda": api.LDA, "flda": api.fLDA, "ctm": api.CTM,
           "fctm": api.fCTM, "ctpf": api.CTPF, "dtm": api.DTM,
           "hmtm": api.HMTM}[args.model]
    ctor_kw = dict(runtime=runtime, mesh=mesh, device=device,
                   seed=0 if args.seed is None else args.seed)
    if args.model == "dtm":
        ctor_kw["delta"] = args.delta
    if args.identify:
        if args.model not in ("ctm", "fctm"):
            raise SystemExit("--identify only applies to ctm/fctm "
                             "(the logistic-normal gauge fix)")
        ctor_kw["identify"] = True
    model = cls(corp, args.k, **ctor_kw)

    train_kw = dict(iter=args.iter, tol=args.tol, viter=args.viter,
                    vtol=args.vtol, checkelbo=_checkelbo(args),
                    printelbo=not (args.quiet or args.json))
    if args.model not in ("ctpf",):   # CTPF train! has no niter/ntol
        train_kw.update(niter=args.niter, ntol=args.ntol)
    model.train(**train_kw)

    if args.save:
        from . import checkpoint

        checkpoint.save(args.save, model)

    summary = model.trainer.summary()
    summary.update(model=args.model, K=args.k, M=model.M, V=model.V)
    return summary


def _pick_stream_batch(M_pad: int, want: int, n_dev: int) -> int:
    """Largest batch <= ``want`` that divides ``M_pad`` and is a multiple
    of the ``n_dev``-way data axis (the streaming constructor rejects
    anything else); 0 when no such batch exists."""
    best = 0
    d = 1
    while d * d <= M_pad:           # enumerate divisor pairs in O(sqrt M)
        if M_pad % d == 0:
            for b in (d, M_pad // d):
                if b <= want and b % n_dev == 0:
                    best = max(best, b)
        d += 1
    return best


def _run_streaming(args, corp, runtime, mesh=None) -> dict:
    import numpy as np

    from .corpus import Corpus
    from .ops.packing import pack_corpus
    from .parallel import multihost
    from .parallel.mesh import axis_size
    from .streaming import (StreamingCTM, StreamingCTPF, StreamingDTM,
                            StreamingFCTM, StreamingFLDA, StreamingHMTM,
                            StreamingLDA, slices_from_stamps)

    cls = {"lda": StreamingLDA, "flda": StreamingFLDA,
           "ctm": StreamingCTM, "fctm": StreamingFCTM,
           "ctpf": StreamingCTPF, "hmtm": StreamingHMTM,
           "dtm": StreamingDTM}[args.model]

    if args.model == "dtm" and not isinstance(corp, Corpus):
        raise SystemExit(
            "--streaming/--online dtm needs a Corpus with per-document "
            "stamps (the slice assignment comes from them); packed "
            "synthetic input carries no stamps.")

    is_ctpf = args.model == "ctpf"
    # batch_docs is GLOBAL: it must also split across the processes
    n_dev = axis_size(mesh, runtime.data_axis) * multihost.process_count()
    if isinstance(corp, Corpus):
        # round the padded doc count to a multiple of n_dev as well, so a
        # batch satisfying (batch | M_pad, n_dev | batch) always exists
        dm = min(args.batch_docs, runtime.chunk_docs)
        dm *= n_dev // math.gcd(dm, n_dev)
        packed = pack_corpus(corp, pad_multiple=runtime.pad_multiple,
                             docs_multiple=dm,
                             with_readers=is_ctpf,
                             dtype=np.dtype(runtime.dtype))
    else:
        packed = corp
    batch = _pick_stream_batch(packed.M_pad, args.batch_docs, n_dev)
    if batch == 0:
        raise SystemExit(
            f"--streaming: no batch size <= {args.batch_docs} divides the "
            f"packed doc count {packed.M_pad} as a multiple of the "
            f"{n_dev}-device data axis; repack the corpus with a doc "
            f"padding that is a multiple of {n_dev}, or adjust "
            f"--batch-docs.")
    per_dev = max(batch // n_dev, 1)
    chunk = min(runtime.chunk_docs, per_dev)
    while per_dev % chunk:   # the driver needs chunk | batch/n_dev
        chunk -= 1
    extra = {}
    if args.model == "dtm":
        stamps = [d.stamp for d in corp.docs]
        if any(s_ is None or not np.isfinite(s_) for s_ in stamps):
            raise SystemExit("every document must carry a finite stamp "
                             "(read the corpus with --stamps).")
        T, slice_id = slices_from_stamps(stamps, args.delta,
                                         M_pad=packed.M_pad)
        extra = dict(T=T, slice_id=slice_id)
    s = cls(packed, args.k, batch_docs=batch,
            chunk_docs=chunk,
            dtype=runtime.dtype,
            seed=0 if args.seed is None else args.seed,
            mesh=mesh, data_axis=runtime.data_axis,
            state_dir=args.state_dir, device=args.device, **extra)
    quiet = not (args.quiet or args.json)
    ckpt = dict(checkpoint_every=args.checkpoint_every or 0,
                checkpoint_dir=args.checkpoint_dir)
    newton = {} if is_ctpf else dict(niter=args.niter, ntol=args.ntol)
    if args.model == "dtm":
        newton["cgiter"] = args.cgiter
    if args.online:
        s.train_online(epochs=args.iter, tau0=args.tau0, kappa=args.kappa,
                       viter=args.viter, vtol=args.vtol, **newton,
                       checkelbo=_checkelbo(args), printelbo=quiet, **ckpt)
    else:
        s.train(iter=args.iter, tol=args.tol, viter=args.viter,
                vtol=args.vtol, **newton,
                checkelbo=_checkelbo(args), printelbo=quiet, **ckpt)
    if args.save:
        s.save(args.save)
    return dict(model=args.model,
                mode="online" if args.online else "streaming",
                K=args.k, M=s.M, V=s.V, batch_docs=batch,
                final_elbo=(s.trace[-1][1] if s.trace else None))


def main(argv=None) -> int:
    summary = run(argv)
    print(json.dumps({k: v for k, v in summary.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
