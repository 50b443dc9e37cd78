"""CTM and fCTM steps with their CG solves through CUDA graphs against the
eager CG loop, in turns (graph, eager, eager, graph) from one state, with
mu compared bit for bit; then the host-side breakdown of one graphed step
under ``torch.profiler``.

    python3 tools/ctm_cg_graph_ab.py

Needs one CUDA GPU.  NSF-scale corpus, K = 50, the models' default
2048-document chunks, one warm-up step each.  The eager runs swap
``ops/newton.py``'s graphed CG for its eager loop, the CPU's path.
"""
import pathlib
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import topicmodelsvb_jl_torch as tt  # noqa: E402
from topicmodelsvb_jl_torch.ops import newton  # noqa: E402


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    packed = tt.synth_packed_nsf_scale(seed=7)
    graphed_cg = newton._cg_graphed
    for name, cls in (("CTM", tt.CTM), ("fCTM", tt.fCTM)):
        m = cls(packed, 50, device="cuda", seed=7)
        m.train(iter=1, checkelbo=float("inf"), printelbo=False)
        tr = m.trainer
        state = m.state
        out = {}
        for label in ("graph", "eager", "eager", "graph"):
            newton._cg_graphed = graphed_cg if label == "graph" else newton._cg_eager
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s = tr.step_fn(state, *tr.data)
            torch.cuda.synchronize()
            out.setdefault(label, []).append(time.perf_counter() - t0)
            out.setdefault(label + "_mu", s.mu)
        newton._cg_graphed = graphed_cg
        same = torch.equal(out["graph_mu"], out["eager_mu"])
        diff = float((out["graph_mu"] - out["eager_mu"]).abs().max())
        print(f"== {name} step: CG graphs {out['graph']} s, eager {out['eager']} s, mu bitwise "
              f"equal {same}, max diff {diff:.3e}; card {torch.cuda.get_device_name(0)}")
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            tr.step_fn(state, *tr.data)
            torch.cuda.synchronize()
        ka = prof.key_averages()
        for e in sorted(ka, key=lambda e: e.self_cpu_time_total, reverse=True)[:12]:
            print(f"   cpu self {e.self_cpu_time_total / 1e3:9.1f} ms  n={e.count:7d}  "
                  f"{e.key[:70]}")


if __name__ == "__main__":
    main()
