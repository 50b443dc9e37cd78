"""Where a DTM trained in f32 departs from the same DTM in f64, stage by stage.

    python3 tools/dtm_f32_error.py [--objective-f64]

Builds ``chip_smoke.py``'s small DTM (M = 1,500, V = 600, 5 slices,
K = 10) in f64 on the CPU and copies its init into f32 models: on the CPU
and, when a CUDA device is there, on the card.  Each f32 model is held
against the f64 one per element (``max |a − b| / (1e-6 + |b|)``, the count
of elements outside rtol 1e-3, atol 1e-6, and the norm of the difference
over the norm):

1. one E-step sweep from the init: gamma, Elogtheta, lzeta, A, wz, the
   Elogtheta sums and the document counts;
2. the M-step from the f64 sweep's statistics rounded to f32: the alpha
   Newtons alone (no CG iteration), then with 5 CG iterations at
   cgtol = 0 and at the default cgtol = 1/T², each with the sequence of
   objective values the CG evaluated;
3. three training iterations at cgiter = 5, cgtol = 0 and at the default
   cgtol, from that init, and at cgtol = 0 from the init an f32 model
   draws itself (``chip_smoke.card_vs_cpu``'s start): alpha, betahat,
   mbeta and the ELBO, the worst betahat entries and their word's count
   in the slice, the objective evaluations of each run and the first at
   which the f32 run's values part from the f64 run's by 1e-5, and on
   the card whether the run is bitwise the same without the host read
   that records each objective value;
4. the same 3 iterations in f32 from the f32 init with every betahat
   moved by one ulp, against the run from the init itself on the same
   device: how far f32 rounding alone carries the result;
5. the streamed DTM of ``tests/test_torch_cuda.py`` (K = 8, batches of
   1,024, chunks of 256) at the defaults (cgiter = 20, cgtol = 1/T²) and
   at the test's cgiter = 5, cgtol = 0, on a corpus without time
   structure (``synth_packed_nsf_scale(M=2000, V=800)``, row i in slice
   i mod 4) and on the stamped corpus that test uses: betahat and the
   ELBO after 1 and 2 iterations in f32 against f64 on the CPU, all from
   the f64 model's init, then all from the CPU f32 model's (the test
   copies one f32 model's init into the other).

``--objective-f64`` evaluates the CG objective in f64 from the f32
betahat (its gradient comes back in f32), to see whether the f32 rounding
of the objective's sums decides the line searches.  Prints one JSON line
last and appends it to ``chiprun_out/dtm_f32_error.jsonl``.
"""
import itertools
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def compare(got, want):
    """(max elementwise rel err at atol 1e-6, elements outside rtol 1e-3 /
    atol 1e-6, norm of the difference over the norm)."""
    import numpy as np

    a = np.asarray(got, np.float64)
    b = np.asarray(want, np.float64)
    d = np.abs(a - b)
    return {"rel": float(np.max(d / (1e-6 + np.abs(b)))),
            "n_out": int(np.sum(d > 1e-6 + 1e-3 * np.abs(b))),
            "n": int(b.size),
            "norm": float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))}


def main(argv) -> int:
    import numpy as np
    import torch

    import topicmodelsvb_jl_torch as tt
    from topicmodelsvb_jl_torch import convert
    from topicmodelsvb_jl_torch.models import dtm as dtm_mod

    obj_f64 = "--objective-f64" in argv
    torch.backends.cuda.matmul.allow_tf32 = False
    plain_objective = dtm_mod.cg_objective
    trace, record = [], [True]

    def objective(betahat, v_filt, vbeta, A, wz):
        if obj_f64:
            f = plain_objective(betahat.double(), v_filt.double(), vbeta.double(), A.double(),
                                wz.double())
        else:
            f = plain_objective(betahat, v_filt, vbeta, A, wz)
        if record[0]:
            trace.append(float(f.detach()))   # a host read: a sync
        return f

    dtm_mod.cg_objective = objective
    small = tt.synth_corpus(M=1500, V=600, K=8, seed=3, n_slices=5, drift=0.2, mean_tokens=60,
                            mean_terms=40)
    make = lambda dtype, dev: tt.DTM(small, 10, delta=1.0, seed=1, device=dev,
                                     runtime=tt.RuntimeConfig(chunk_docs=256, dtype=dtype))
    ref = make("float64", "cpu")
    init = convert.dtm_state_to_numpy(ref.state)
    T = ref.T
    devs = ["cpu"] + (["cuda"] if torch.cuda.is_available() else [])
    out = {"objective_f64": obj_f64, "devices": devs}
    if torch.cuda.is_available():
        out["card"] = subprocess.run(
            ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip()
        print(out["card"])

    def fresh(dtype, dev):
        m = make(dtype, dev)
        m.state = convert.dtm_state_from_numpy(init, dev, getattr(torch, dtype))
        return m

    # 1. one sweep from the init
    names = ("gamma", "Elogtheta", "lzeta", "A", "wz", "els", "nd")

    def sweep_np(m):
        sweep = dtm_mod.make_sweep(m.packed, m.K, T, 10, 1.0 / m.K**2, m.chunk_docs,
                                   m.slice_id, m.device)
        g, el, lz, A, wz, els, nd = sweep(m.state, *m._step_data())
        return dict(zip(names, (x.cpu().numpy() for x in (g, el, lz, A, wz, els[0], nd)))), \
            (A, wz, els, nd)

    m64 = fresh("float64", "cpu")
    want, stats64 = sweep_np(m64)
    out["sweep"] = {}
    for dev in devs:
        got, _ = sweep_np(fresh("float32", dev))
        out["sweep"][dev] = {n: compare(got[n], want[n]) for n in names}
        print(f"sweep {dev} f32 vs cpu f64: " + ", ".join(
            f"{n} rel {c['rel']:.2e} out {c['n_out']}/{c['n']} norm {c['norm']:.2e}"
            for n, c in out["sweep"][dev].items()))

    # 2. the M-step from the f64 statistics rounded to f32
    def update(m, cgiter, cgtol):
        st = m.state
        dt = st.betahat.dtype
        A, wz, els, nd = (x.to(st.betahat.device, dt) if torch.is_tensor(x) else
                          tuple(y.to(st.betahat.device, dt) for y in x) for x in stats64)
        fn = dtm_mod.make_global_update(1000, 1.0 / m.K**2, cgiter, cgtol)
        del trace[:]
        a, bh, mb = fn(st.alpha, st.betahat, st.v_filt, st.vbeta, A, wz, els[0], els[1], nd)
        return [x.cpu().numpy() for x in (a, bh, mb)], list(trace)

    out["update"] = {}
    for cgiter, cgtol in ((0, 0.0), (5, 0.0), (5, 1.0 / T**2)):
        key = f"cgiter={cgiter},cgtol={cgtol:g}"
        want, ftrace64 = update(m64, cgiter, cgtol)
        out["update"][key] = {"f64": ftrace64}
        print(f"update {key} cpu f64 objective values {ftrace64}")
        for dev in devs:
            got, ftrace = update(fresh("float32", dev), cgiter, cgtol)
            cmp = {n: compare(g, w) for n, g, w in zip(("alpha", "betahat", "mbeta"), got, want)}
            out["update"][key][dev] = dict(cmp, objective=ftrace)
            print(f"update {key} {dev} f32: " + ", ".join(
                f"{n} rel {c['rel']:.2e} out {c['n_out']}/{c['n']} norm {c['norm']:.2e}"
                for n, c in cmp.items()) + f"; objective values {ftrace}")

    # 3. three training iterations, as chip_smoke.card_vs_cpu runs them,
    # from the f64 init and from the init an f32 model draws itself
    counts = np.zeros((T, ref.V))
    for d, s in zip(small.docs, ref.slice_id[:ref.M]):
        np.add.at(counts[s], np.asarray(d.terms) - 1, d.counts)
    init32 = convert.dtm_state_to_numpy(make("float32", "cpu").state)

    def diverges(a, b):
        """First index where two objective traces differ by more than
        1e-5 relative, or None; trial values below -1e10 (steps the line
        search halves at once) are skipped."""
        for i, (x, y) in enumerate(zip(a, b)):
            if y > -1e10 and abs(x - y) > 1e-5 * abs(y):
                return i
        return None if len(a) == len(b) else min(len(a), len(b))

    out["train"] = {}
    for start, cgtol in (("f64 init", 0.0), ("f64 init", 1.0 / T**2), ("f32 init", 0.0)):
        if start == "f32 init":
            init = init32
        key = f"{start},cgiter=5,cgtol={cgtol:g}"
        m = fresh("float64", "cpu")
        del trace[:]
        m.train(iter=3, checkelbo=1, printelbo=False, cgiter=5, cgtol=cgtol)
        ftrace64 = list(trace)
        out["train"][key] = {}
        for dev in devs:
            g = fresh("float32", dev)
            del trace[:]
            g.train(iter=3, checkelbo=1, printelbo=False, cgiter=5, cgtol=cgtol)
            cmp = {f: compare(getattr(g, f), getattr(m, f)) for f in ("alpha", "betahat", "mbeta")}
            cmp["objective_evals"] = [len(trace), len(ftrace64)]
            cmp["objective_diverges_at"] = diverges(trace, ftrace64)
            if dev == "cuda":   # the same run without the objective's host reads
                record[0] = False
                h = fresh("float32", dev)
                h.train(iter=3, checkelbo=1, printelbo=False, cgiter=5, cgtol=cgtol)
                record[0] = True
                cmp["same_without_reads"] = bool(np.array_equal(h.betahat, g.betahat))
            ge = [x.elbo for x in g.trainer.trace]
            me = [x.elbo for x in m.trainer.trace]
            cmp["elbo_rel"] = max(abs(a - b) / abs(b) for a, b in zip(ge, me))
            d = np.abs(np.asarray(g.betahat, np.float64) - m.betahat)
            worst = np.argsort(d, axis=None)[::-1][:5]
            cmp["worst_betahat"] = [
                {"t": int(t), "k": int(k), "v": int(v) + 1, "diff": float(d[t, k, v]),
                 "count_in_slice": float(counts[t, v])}
                for t, k, v in zip(*np.unravel_index(worst, d.shape))]
            out["train"][key][dev] = cmp
            print(f"train {key} {dev} f32: " + ", ".join(
                f"{n} rel {cmp[n]['rel']:.2e} out {cmp[n]['n_out']}/{cmp[n]['n']} "
                f"norm {cmp[n]['norm']:.2e}" for n in ("alpha", "betahat", "mbeta"))
                + f"; ELBO rel {cmp['elbo_rel']:.2e}; objective evaluations (f32, f64) "
                f"{cmp['objective_evals']}, traces part at {cmp['objective_diverges_at']}"
                + (f"; bitwise equal without the reads: {cmp['same_without_reads']}"
                   if dev == "cuda" else "") + f"; worst betahat {cmp['worst_betahat']}")
    # 4. how far 3 iterations in f32 move when the init moves by one ulp
    init = dict(init32, betahat=np.nextafter(init32["betahat"], np.float32(np.inf)))
    out["one_ulp"] = {}
    for dev in devs:
        base = fresh("float32", dev)
        base.state = convert.dtm_state_from_numpy(init32, dev, torch.float32)
        nudged = fresh("float32", dev)
        for m in (base, nudged):
            m.train(iter=3, checkelbo=1, printelbo=False, cgiter=5, cgtol=0.0)
        cmp = {f: compare(getattr(nudged, f), getattr(base, f))
               for f in ("alpha", "betahat", "mbeta")}
        out["one_ulp"][dev] = cmp
        print(f"one ulp on the f32 init's betahat, 3 iterations, {dev} f32 against itself: "
              + ", ".join(f"{n} rel {c['rel']:.2e} out {c['n_out']}/{c['n']} norm {c['norm']:.2e}"
                          for n, c in cmp.items()))
    # 5. the streamed DTM, on corpora without and with time structure
    pk = tt.synth_packed_nsf_scale(M=2000, V=800, mean_terms=30, seed=5, chunk_docs=1024)
    stamped = tt.synth_corpus(M=2000, V=600, K=8, seed=3, n_slices=5, drift=0.2,
                              mean_tokens=60, mean_terms=40)
    spk = tt.pack_corpus(stamped, docs_multiple=1024)
    corpora = {
        "no time structure": (pk, 4, (np.arange(pk.M_pad) % 4).astype(np.int32)),
        "stamped": (spk,) + tuple(tt.slices_from_stamps([d.stamp for d in stamped.docs], 1.0,
                                                          spk.M_pad))}
    out["streamed"] = {}
    cg_runs = {"cgiter=20, cgtol=1/T²": {}, "cgiter=5, cgtol=0": dict(cgiter=5, cgtol=0.0)}
    for (label, (p, T_s, sid)), start, (cg, cg_kw) in itertools.product(
            corpora.items(), ("f64 init", "f32 init"), cg_runs.items()):
        mk = lambda dt, dev: tt.StreamingDTM(p, 8, T_s, sid, batch_docs=1024, chunk_docs=256,
                                             dtype=dt, seed=1, device=dev)
        runs = {"cpu f64": mk(torch.float64, "cpu")}
        for dev in devs:
            runs[f"{dev} f32"] = mk(torch.float32, dev)
        src = runs["cpu f64" if start == "f64 init" else "cpu f32"]
        for m in runs.values():
            if m is not src:
                convert.streaming_from(m, src)
        betas = {k: [] for k in runs}
        for _ in range(2):
            for k, m in runs.items():
                m.train(iter=1, checkelbo=1, printelbo=False, **cg_kw)
                betas[k].append(m.betahat.double().cpu().numpy())
        ref64 = runs.pop("cpu f64")
        key = f"{label}, {start}, {cg}"
        out["streamed"][key] = {}
        for k, m in runs.items():
            rows = [{"betahat_norm": compare(b32, b64)["norm"],
                     "elbo_rel": abs(x[1] - y[1]) / abs(y[1])}
                    for b32, b64, x, y in zip(betas[k], betas["cpu f64"], m.trace,
                                              ref64.trace)]
            out["streamed"][key][k] = rows
            print(f"streamed DTM, {key}, {k} against cpu f64: " + "; ".join(
                f"iteration {i + 1} betahat norm {r['betahat_norm']:.2e}, ELBO rel "
                f"{r['elbo_rel']:.2e}" for i, r in enumerate(rows)))
    line = json.dumps(out)
    dst = ROOT / "chiprun_out"
    dst.mkdir(exist_ok=True)
    with open(dst / "dtm_f32_error.jsonl", "a") as f:
        f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
