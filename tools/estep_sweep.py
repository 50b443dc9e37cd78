"""Time ``lda_estep``, ``flda_estep``, ``ctpf_estep`` or ``hmtm_estep`` at
their main path's widest chunk and at a chunk whose rows do not fit shared
memory for a range of ``viter``, or ``lda_elbo_tok`` at LDA's chunks and
at CTM's (K = 50, 2048 documents), from the package of a given checkout,
with chip_smoke.py's timer.

    python3 tools/estep_sweep.py ROOT LABEL [lda|flda|ctpf|elbo|hmtm]

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
K = 100, and L = 4,096) with ``hmtm_logz`` beside each.  viter = 0 runs no pass (the
loads and the row writes alone); the slope over viter is the cost of a
pass.  Prints one JSON line tagged LABEL with the device and call ms of
each (shape, viter), and appends it to ``chiprun_out/estep_sweep.jsonl``.
The kernel defaults to ``lda``.  Needs one CUDA GPU.
"""
import importlib.util
import json
import pathlib
import sys

VITERS = (0, 1, 2, 5, 10)


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
    if kernel not in ("lda", "flda", "ctpf", "elbo", "hmtm"):
        raise SystemExit(f"estep_sweep: no kernel {kernel!r}")
    dev = torch.device("cuda", 0)
    packed = tt.synth_packed_nsf_scale(seed=7)
    s0 = tt.bucketize_packed(packed, chunk=1024, pad_multiple=8).segments[0]
    V, K = packed.V, 100
    put = lambda a, dt: torch.as_tensor(np.ascontiguousarray(a), dtype=dt).to(dev)
    out = {"label": label, "kernel": kernel, "card": torch.cuda.get_device_name(0)}
    if kernel == "hmtm":
        from topicmodelsvb_jl_torch.kernels.hmtm_estep import hmtm_estep, hmtm_logz

        bucketed = tt.bucketize_packed(packed, chunk=1024, pad_multiple=8)
        for label_, Kh, _, _, args in smoke.hmtm_chunks(bucketed, V, dev)[:3]:
            for viter in VITERS:
                out[f"{label_} viter={viter}"] = list(smoke.time_calls(
                    lambda: hmtm_estep(*args, viter=viter, vtol=1.0 / Kh**2)))
            out[f"{label_} logz"] = list(smoke.time_calls(
                lambda: hmtm_logz(*args[:3], args[6], args[7])))
        return emit(here, out)
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
        if kernel == "lda":
            g = torch.Generator().manual_seed(11)
            betaT = (dirichlet_ones(g, V, (K,)).to(dev) + EPSILON).T.contiguous()
            args = (betaT, terms, counts, doc_mask, *smoke.warm_state(K, B, dev, seed=12))
            fn = lda_estep
        else:
            g = torch.Generator().manual_seed(21)
            logbetaT = torch.log(dirichlet_ones(g, V, (K,)) + EPSILON).T.contiguous().to(dev)
            kappa = dirichlet_ones(g, V).to(dev)
            tau, tau_old = ((0.1 + 0.8 * torch.rand(B, L, generator=g)).to(dev) for _ in range(2))
            alpha, gamma, El, El_old = smoke.warm_state(K, B, dev, seed=22)
            args = (logbetaT, kappa, terms, counts, doc_mask, alpha,
                    torch.tensor(0.6, device=dev), gamma, El, El_old, tau, tau_old)
            fn = flda_estep
        for viter in VITERS:
            ms, call = smoke.time_calls(lambda: fn(*args, viter=viter, vtol=1.0 / K**2))
            out[f"{name} viter={viter}"] = [ms, call]
    return emit(here, out)


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
