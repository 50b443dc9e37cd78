"""Time ``lda_estep`` at the widest NSF chunk and at L = 1024 for a range of
``viter``, from the package of a given checkout, with chip_smoke.py's timer.

    python3 tools/estep_sweep.py ROOT LABEL

ROOT holds a checkout of this repository (``.`` for this one, or a
``git archive`` unpacked into a directory that ``.gitignore`` lists); its
``topicmodelsvb_jl_torch`` is imported and built.  The chunks and the warm
state are chip_smoke.py's (``kernel_checks``'s widest NSF bucket, 1024
documents, K = 100, and its synthetic L = 1024 chunk).  viter = 0 runs no
pass (the load and the w write alone); the slope over viter is the cost of
a pass.  Prints one JSON line tagged LABEL with the device and call ms of
each (shape, viter), and appends it to ``chiprun_out/estep_sweep.jsonl``.
Needs one CUDA GPU.
"""
import importlib.util
import json
import pathlib
import sys

VITERS = (0, 1, 2, 5, 10)


def main(root: str, label: str) -> int:
    here = pathlib.Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(pathlib.Path(root).resolve()))
    spec = importlib.util.spec_from_file_location("chip_smoke_timer", here / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    import numpy as np
    import torch

    import topicmodelsvb_jl_torch as tt
    from topicmodelsvb_jl_torch.kernels.lda_estep import lda_estep
    from topicmodelsvb_jl_torch.utils.numerics import EPSILON, dirichlet_ones

    if not torch.cuda.is_available():
        print("estep_sweep: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    packed = tt.synth_packed_nsf_scale(seed=7)
    s0 = tt.bucketize_packed(packed, chunk=1024, pad_multiple=8).segments[0]
    V, K = packed.V, 100
    put = lambda a, dt: torch.as_tensor(np.ascontiguousarray(a), dtype=dt).to(dev)
    r = np.random.default_rng(3)
    n = r.integers(600, 1025, size=1024)
    cnt = (1 + r.poisson(0.35, size=(1024, 1024))) * (np.arange(1024)[None, :] < n[:, None])
    trm = np.minimum((V * r.random((1024, 1024)) ** 3).astype(np.int32), V - 1) * (cnt > 0)
    chunks = {f"L={s0.L}": (put(s0.terms[:1024], torch.int32), put(s0.counts[:1024], torch.float32),
                            put(s0.doc_mask[:1024], torch.float32)),
              "L=1024": (put(trm, torch.int32), put(cnt, torch.float32),
                         torch.ones(1024, dtype=torch.float32, device=dev))}
    g = torch.Generator().manual_seed(11)
    betaT = (dirichlet_ones(g, V, (K,)).to(dev) + EPSILON).T.contiguous()
    out = {"label": label, "card": torch.cuda.get_device_name(0)}
    for name, (terms, counts, doc_mask) in chunks.items():
        state = smoke.warm_state(K, 1024, dev, seed=12)
        for viter in VITERS:
            args = (betaT, terms, counts, doc_mask, *state)
            ms, call = smoke.time_calls(lambda: lda_estep(*args, viter=viter, vtol=1.0 / K**2))
            out[f"{name} viter={viter}"] = [ms, call]
    line = json.dumps(out)
    print(line)
    dest = here / "chiprun_out"
    dest.mkdir(exist_ok=True)
    with open(dest / "estep_sweep.jsonl", "a") as f:
        f.write(line + "\n")
    return 0


if __name__ == "__main__":
    if len(sys.argv) != 3:
        raise SystemExit(__doc__)
    sys.exit(main(sys.argv[1], sys.argv[2]))
