"""``load_mac()``'s build time, and the scatter on the first chunk of a DTM
built from it, beside ``chip_smoke.mac_corpus``'s stand-in.

    python3 tools/load_mac_scatter.py

``chip_smoke.py``'s DTM phase trains on ``mac_corpus``, a stamped corpus
at the mac shape drawn from seeded numpy arrays, and not on
``load_mac()``, whose synthetic build draws each document on the host.
This times ``load_mac()`` (no mac files: the synthetic build at
M = 75,011, V = 15,113, 12 slices) and ``mac_corpus()``, builds
``DTM(corp, 20, delta=1.0)`` on each, and runs ``chip_smoke``'s check of
the scatter on the first chunk of each init (both plans, against the
plain version and ``index_add_``): how often term ids collide within a
chunk is set by the corpus, and so is the scatter's time beside
``index_add_``.  Prints the card, one line per corpus and one JSON line
last, and appends that to ``chiprun_out/load_mac_scatter.jsonl``.
Needs one CUDA GPU.
"""
import importlib.util
import json
import pathlib
import subprocess
import sys
import time
import warnings

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("load_mac_scatter: no CUDA device", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import topicmodelsvb_jl_torch as tt

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip()
    print(smi)
    out = {"card": smi}
    for name, build in (("load_mac", tt.load_mac), ("mac_corpus", smoke.mac_corpus)):
        t0 = time.perf_counter()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            corp = build()
        build_s = time.perf_counter() - t0
        dtm = tt.DTM(corp, 20, delta=1.0, seed=7)
        B = dtm.chunk_docs
        p = dtm.packed
        rows = (dtm.slice_id[:B].astype(np.int64)[:, None] * dtm.V + p.terms[:B])[p.counts[:B] > 0]
        recs = smoke.dtm_chunk_scatter(dtm, dev, name)
        row = {"build_s": build_s, "M": dtm.M, "V": dtm.V, "T": dtm.T, "L": dtm.packed.L,
               "mean_terms": float(np.mean(dtm.N)), "mean_tokens": float(np.mean(dtm.C)),
               "first_chunk_slots": int(rows.size),
               "first_chunk_distinct_rows": int(np.unique(rows).size),
               "scatter": [{k: r[k] for k in ("label", "ms", "plain_ms", "bound_ms",
                                              "library_ms", "max_abs_err")} for r in recs]}
        out[name] = row
        print(f"{name}: built in {build_s:.2f} s; M={dtm.M} V={dtm.V} T={dtm.T} L={dtm.packed.L} "
              f"mean terms {row['mean_terms']:.1f}; first chunk {row['first_chunk_slots']} slots, "
              f"{row['first_chunk_distinct_rows']} distinct rows of A")
        del dtm, corp
        torch.cuda.empty_cache()
    line = json.dumps(out)
    dst = ROOT / "chiprun_out"
    dst.mkdir(exist_ok=True)
    with open(dst / "load_mac_scatter.jsonl", "a") as f:
        f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
