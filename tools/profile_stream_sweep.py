"""Where a StreamingLDA sweep's time goes, on one CUDA GPU.

    python3 tools/profile_stream_sweep.py

Builds ``chip_smoke.py`` phase 10's main path (the dense synthetic NSF
corpus, 131,072 rows of L = 128, ``StreamingLDA(packed, 100,
batch_docs=8192, chunk_docs=1024)``, f32) and sweeps once to build the
scatter plans.  Then, each on its own: three unprofiled sweeps (wall); one
sweep under ``cProfile`` (the host functions by their own time); one sweep
under ``torch.profiler`` (kernel and copy device time by name, launches,
the compute kernels' share of the wall); one bound pass under ``cProfile``.
Prints the card's name and power limit first.
"""
import cProfile
import io
import pathlib
import pstats
import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import topicmodelsvb_jl_torch as tt  # noqa: E402
from topicmodelsvb_jl_torch.utils.config import TrainConfig  # noqa: E402


def dev_time(e):
    return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)


def host_top(fn, n=18) -> str:
    pr = cProfile.Profile()
    pr.enable()
    fn()
    torch.cuda.synchronize()
    pr.disable()
    buf = io.StringIO()
    pstats.Stats(pr, stream=buf).sort_stats("tottime").print_stats(n)
    return buf.getvalue()


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip())
    packed = tt.synth_packed_nsf_scale(chunk_docs=8192)
    m = tt.StreamingLDA(packed, 100, batch_docs=8192, chunk_docs=1024, seed=7)
    m._compile(TrainConfig().resolved(100))
    sweep = lambda: m._streamed_sweep(m._zero_stats())
    sweep()
    torch.cuda.synchronize()
    print(f"plans: {m.plan_build_s:.3f} s to build, {m.plan_cache_bytes / 2**20:.1f} MiB")
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        sweep()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    print("sweep walls (s):", ", ".join(f"{w:.4f}" for w in walls))
    print("== one sweep under cProfile, by own time")
    print(host_top(sweep))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sweep()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    copies = [e for e in dev if e.key.startswith("Memcpy")]
    kernels = [e for e in dev if not e.key.startswith(("Memcpy", "Memset"))]
    busy = sum(dev_time(e) for e in kernels) / 1e3
    print(f"== one sweep under torch.profiler: wall {wall * 1e3:.1f} ms (profiled); compute "
          f"kernels {busy:.1f} ms device ({100 * busy / (wall * 1e3):.1f}% of the wall), "
          f"{sum(e.count for e in kernels)} launches; copies "
          f"{sum(dev_time(e) for e in copies) / 1e3:.1f} ms device in "
          f"{sum(e.count for e in copies)} calls")
    for e in sorted(dev, key=dev_time, reverse=True)[:12]:
        print(f"  {dev_time(e) / 1e3:8.2f} ms  {e.count:5d}x  {e.key[:90]}")
    t0 = time.perf_counter()
    m._sweep_elbo()   # the first pass also compiles the digamma/lgamma kernels
    print(f"first bound pass {time.perf_counter() - t0:.3f} s")
    print("== one bound pass under cProfile, by own time")
    print(host_top(m._sweep_elbo, 12))


if __name__ == "__main__":
    main()
