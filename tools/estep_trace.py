"""Per-phase clock marks of one steady pass of ``lda_estep``'s float64
resident design (``lda_estep_res_kernel``), from an instrumented copy.

    python3 tools/estep_trace.py ROOT LABEL

ROOT holds a checkout of this repository (``.`` for this one).  Its
``topicmodelsvb_jl_torch`` is copied into a fresh directory under ROOT's
``_tmp/`` (which ``.gitignore`` lists), and the copy's ``lda_estep.cu`` gets
``clock64()`` marks in the third pass of every document: thread 0 (the
CTA's first half, which takes El) at the start of the pass, at each round
of the slot phase, after the fold, after the fold's barrier, after gamma,
psi and the El stores, and after the stop test; thread 128 (the second
half, which takes the next e) after gamma, exp_digamma, the division and
its store.  The copy is built and run on the widest NSF chunk in float64
(chip_smoke.py's arguments, as ``tools/estep_sweep.py lda_double`` takes
them) at viter 10, with 132 and with 1024 documents (one and two documents
an SM).  Prints the median cycles of each phase over the documents and
the instrumented copy's device ms, one JSON line tagged LABEL, appended to
``chiprun_out/estep_trace.jsonl``.  The marks cost a few percent of a
pass; compare phases, not the copy's time with the kernel's.  Needs one
CUDA GPU.
"""
import ctypes
import importlib.util
import json
import pathlib
import shutil
import sys
import tempfile

# (anchor in lda_estep.cu, replacement): the marks
MARKS = [
    ("namespace tmvb {\n\nconstexpr int kEstepThreads = 256;",
     "namespace tmvb {\n__device__ long long tmvb_lda_trace[1024 * 40];\n"
     "#define TMVB_MARK(i) do { if (blockIdx.x < 1024) "
     "tmvb_lda_trace[blockIdx.x * 40 + (i)] = clock64(); } while (0)\n\n"
     "constexpr int kEstepThreads = 256;"),
    ("                                              double* wd, const int* mslot, int n, int K,\n"
     "                                              bool rows_out) {",
     "                                              double* wd, const int* mslot, int n, int K,\n"
     "                                              bool rows_out, bool trace = false) {"),
    ("    double x[D][NV], s[D];\n",
     "    if (trace && threadIdx.x == 0) TMVB_MARK(1 + min(j0 / (kEstepWarps * W), 5));\n"
     "    double x[D][NV], s[D];\n"),
    ("    lda_res_slots<G, NV, D>(rows, e, acc, mc, mcs, wd, mslot, n, K, it == viter - 1);\n"
     "    if (warp < nb) lda_res_fold<G, NV>(acc, e, qpart + warp * K, red + warp, K);\n",
     "    if (it == 2 && tid == 0) TMVB_MARK(0);\n"
     "    lda_res_slots<G, NV, D>(rows, e, acc, mc, mcs, wd, mslot, n, K, it == viter - 1,"
     " it == 2);\n"
     "    if (it == 2 && tid == 0) TMVB_MARK(7);\n"
     "    if (warp < nb) lda_res_fold<G, NV>(acc, e, qpart + warp * K, red + warp, K);\n"
     "    if (it == 2 && tid == 0) TMVB_MARK(8);\n"),
    ("    const R gs = asum + lda_res_sum8(red, 1);\n",
     "    if (it == 2 && tid == 0) TMVB_MARK(9);\n    const R gs = asum + lda_res_sum8(red, 1);\n"),
    ("      const R g0 = mine ? lda_res_gamma(alpha0, qpart, e_cur, K, k0) : R(1);\n",
     "      const R g0 = mine ? lda_res_gamma(alpha0, qpart, e_cur, K, k0) : R(1);\n"
     "      if (it == 2 && (tid == 0 || tid == 128) && g0 > -1.0) TMVB_MARK(tid == 0 ? 10 : 20);\n"),
    ("        if (mine) e_nxt[k0] = f / den;\n",
     "        if (it == 2 && tid == 128 && f > -1.0) TMVB_MARK(21);\n"
     "        if (mine) e_nxt[k0] = f / den;\n"
     "        if (it == 2 && tid == 128 && e_nxt[k0] > -1.0) TMVB_MARK(22);\n"),
    ("        const R dgs = __shfl_sync(0xffffffffu, f, 31);\n",
     "        const R dgs = __shfl_sync(0xffffffffu, f, 31);\n"
     "        if (it == 2 && tid == 0 && dgs > -1e300) TMVB_MARK(11);\n"),
    ("    dpart = warp_sum(dpart);\n",
     "    if (it == 2 && (tid == 0 || tid == 128)) TMVB_MARK(tid == 0 ? 12 : 23);\n"
     "    dpart = warp_sum(dpart);\n"),
    ("    active = lda_res_sum8(red + kEstepWarps, 1) >= vtol2;\n",
     "    active = lda_res_sum8(red + kEstepWarps, 1) >= vtol2;\n"
     "    if (it == 2 && tid == 0) TMVB_MARK(13);\n"),
    ("extern \"C\" {\n\nconst char* tmvb_error_string(int err) {",
     "extern \"C\" {\n\nint tmvb_lda_trace_copy(long long* host) {\n"
     "  return static_cast<int>(cudaMemcpyFromSymbol(host, tmvb::tmvb_lda_trace,\n"
     "                                              sizeof(tmvb::tmvb_lda_trace)));\n}\n\n"
     "const char* tmvb_error_string(int err) {"),
]

# phase -> (mark, mark): its cycles are the second less the first
PHASES = {"e_load": (0, 1), "round0": (1, 2), "round1": (2, 3), "round2": (3, 4),
          "rounds3+": (4, 7), "fold": (7, 8), "fold_barrier": (8, 9), "gamma": (9, 10),
          "psi": (10, 11), "el_store": (11, 12), "stop_test": (12, 13),
          "e_gamma": (9, 20), "e_exp_digamma": (20, 21), "e_division": (21, 22),
          "e_to_stop_test": (22, 23), "pass": (0, 13)}


def instrument(root: pathlib.Path) -> pathlib.Path:
    """A copy of ROOT's package with the marks, under ROOT/_tmp; returns
    the directory that holds it."""
    (root / "_tmp").mkdir(exist_ok=True)
    dest = pathlib.Path(tempfile.mkdtemp(prefix="estep_trace_", dir=root / "_tmp"))
    shutil.copytree(root / "topicmodelsvb_jl_torch", dest / "topicmodelsvb_jl_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    src = dest / "topicmodelsvb_jl_torch" / "kernels" / "csrc" / "lda_estep.cu"
    text = src.read_text()
    for anchor, repl in MARKS:
        if text.count(anchor) != 1:
            raise SystemExit(f"estep_trace: anchor not found once in {src}:\n{anchor}")
        text = text.replace(anchor, repl)
    src.write_text(text)
    return dest


def main(root: str, label: str) -> int:
    here = pathlib.Path(__file__).resolve().parents[1]
    copy = instrument(pathlib.Path(root).resolve())
    sys.path.insert(0, str(copy))
    spec = importlib.util.spec_from_file_location("chip_smoke_timer", here / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("estep_trace: no CUDA device", file=sys.stderr)
        return 2
    import topicmodelsvb_jl_torch as tt
    from topicmodelsvb_jl_torch.kernels import _build
    from topicmodelsvb_jl_torch.kernels.lda_estep import lda_estep
    from topicmodelsvb_jl_torch.utils.numerics import EPSILON, dirichlet_ones

    dev = torch.device("cuda", 0)
    packed = tt.synth_packed_nsf_scale(seed=7)
    s0 = tt.bucketize_packed(packed, chunk=1024, pad_multiple=8).segments[0]
    V, K = packed.V, 100
    put = lambda a, dt: torch.as_tensor(np.ascontiguousarray(a), dtype=dt).to(dev)
    g = torch.Generator().manual_seed(11)
    betaT = (dirichlet_ones(g, V, (K,)).to(dev) + EPSILON).T.contiguous()
    args = (betaT, put(s0.terms[:1024], torch.int32), put(s0.counts[:1024], torch.float32),
            put(s0.doc_mask[:1024], torch.float32), *smoke.warm_state(K, 1024, dev, seed=12))
    args = tuple(a.double() if a.is_floating_point() else a for a in args)
    copy_marks = _build.function("tmvb_lda_trace_copy", [ctypes.c_void_p])
    out = {"label": label, "root": str(pathlib.Path(root).resolve()),
           "card": torch.cuda.get_device_name(0)}
    for B in (132, 1024):
        part = tuple(a[:B] if a.dim() and a.shape[0] == 1024 else a for a in args)
        for _ in range(2):
            lda_estep(*part, viter=10, vtol=1.0 / K**2)
        torch.cuda.synchronize()
        marks = np.zeros(1024 * 40, dtype=np.int64)
        if copy_marks(marks.ctypes.data) != 0:
            raise SystemExit("estep_trace: the marks could not be read")
        m = marks.reshape(1024, 40)[:B]
        out[f"B={B} cycles"] = {name: float(np.median(m[:, b] - m[:, a]))
                                for name, (a, b) in PHASES.items()}
        out[f"B={B} ms"] = smoke.time_calls(lambda: lda_estep(*part, viter=10, vtol=1.0 / K**2))[0]
    line = json.dumps(out)
    print(line)
    dest = here / "chiprun_out"
    dest.mkdir(exist_ok=True)
    with open(dest / "estep_trace.jsonl", "a") as f:
        f.write(line + "\n")
    shutil.rmtree(copy, ignore_errors=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) != 3:
        raise SystemExit(__doc__)
    sys.exit(main(sys.argv[1], sys.argv[2]))
