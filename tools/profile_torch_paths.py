"""One step and one ELBO pass of each main path of the PyTorch port under
``torch.profiler``: wall time, device kernel time and busy share, kernel
launches, host reads (``aten::_local_scalar_dense``) and the top kernels;
then one unprofiled step.

    python3 tools/profile_torch_paths.py [LDA fLDA CTPF CTM fCTM]

Needs one CUDA GPU.  The models and corpora are ``chip_smoke.py``'s main
paths: LDA/fLDA at NSF scale and CTPF at CiteULike scale with K = 100 and
1024-document chunks, CTM/fCTM at NSF scale with K = 50 and their default
2048-document chunks; each takes one warm-up step first.
"""
import pathlib
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import topicmodelsvb_jl_torch as tt  # noqa: E402


def dev_time(e):
    return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)


def main(which):
    torch.backends.cuda.matmul.allow_tf32 = False
    packed = tt.synth_packed_nsf_scale(seed=7)
    if "CTPF" in which:
        citeu = tt.synth_corpus(M=16_980, V=8_000, U=5_551, K=30, seed=7, mean_tokens=60,
                                mean_terms=45, mean_readers=5)
        cpk = tt.pack_corpus(citeu, with_readers=True)
    rt = tt.RuntimeConfig(chunk_docs=1024)
    for name in which:
        m = {"LDA": lambda: tt.LDA(packed, 100, rt, device="cuda", seed=7),
             "fLDA": lambda: tt.fLDA(packed, 100, rt, device="cuda", seed=7),
             "CTPF": lambda: tt.CTPF(cpk, 100, rt, device="cuda", seed=7),
             "CTM": lambda: tt.CTM(packed, 50, device="cuda", seed=7),
             "fCTM": lambda: tt.fCTM(packed, 50, device="cuda", seed=7)}[name]()
        m.train(iter=1, checkelbo=float("inf"), printelbo=False)
        tr = m.trainer
        state = m.state
        for what in ("step", "elbo"):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                if what == "step":
                    state = tr.step_fn(state, *tr.data)
                else:
                    tr.elbo_fn(state, *tr.elbo_data)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            ka = prof.key_averages()
            kern = [e for e in ka if e.device_type == torch.autograd.DeviceType.CUDA]
            busy = sum(dev_time(e) for e in kern) / 1e3
            n_launch = sum(e.count for e in kern)
            reads = sum(e.count for e in ka if e.key == "aten::_local_scalar_dense")
            print(f"== {name} {what}: wall {wall * 1e3:.1f} ms (profiled), device kernels "
                  f"{busy:.1f} ms = {100 * busy / (wall * 1e3):.1f}% busy, {n_launch} kernel "
                  f"launches, {reads} host reads; card {torch.cuda.get_device_name(0)}")
            for e in sorted(kern, key=dev_time, reverse=True)[:6]:
                print(f"   {dev_time(e) / 1e3:9.2f} ms  n={e.count:7d}  {e.key[:90]}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = tr.step_fn(state, *tr.data)
        torch.cuda.synchronize()
        print(f"== {name} step wall unprofiled {time.perf_counter() - t0:.4f} s")


if __name__ == "__main__":
    main(sys.argv[1:] or ["LDA", "fLDA", "CTPF", "CTM", "fCTM"])
