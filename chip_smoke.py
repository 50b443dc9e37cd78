"""Drive the PyTorch port's LDA main path once on one CUDA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA Hopper GPU
(the kernels are built for sm_90a) and the CUDA toolkit.  Phases, each
printing its own lines; any failure exits non-zero:

1. the card's name and power limit, then the kernels' build from
   ``topicmodelsvb_jl_torch/kernels/csrc`` and its time;
2. the synthetic NSF-scale corpus (128,804 docs, V = 25,319, seed 7),
   bucketized as ``LDA`` does (chunk 1024, width multiple 8);
3. each kernel against its plain PyTorch version on the card, at K = 100
   on one 1024-document chunk of the widest bucket and on a synthetic
   chunk of L = 1024 slots (rows beyond the shared-memory limit), then a
   small model trained on the card (f32, kernels) and on the CPU (f64,
   plain versions) from one init;
4. the main path: ``LDA(packed, 100, device="cuda").train(iter=4,
   checkelbo=1)`` — every ∆elbo > 0, ``check_model`` passes, and the
   launch counts show that every chunk of every step and ELBO check went
   through the kernels;
5. two fresh same-seed models, one step each, bitwise equal;
6. one JSON line per kernel, the card again, and last
   ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
import time


def need(cond, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cuda_ms(fn, reps: int) -> float:
    """Median device time of ``fn`` in ms, after one warm-up call."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def warm_state(K, B, dev, seed):
    """A converging per-document state: gamma > alpha, El = E[log theta]."""
    import torch

    g = torch.Generator().manual_seed(seed)
    alpha = 0.2 + 1.3 * torch.rand(K, generator=g)
    gamma = alpha + 0.1 + 5.0 * torch.rand(B, K, generator=g)
    El = torch.special.digamma(gamma) - torch.special.digamma(gamma.sum(-1, keepdim=True))
    El_old = El + 0.05 * torch.randn(B, K, generator=g)
    return [t.to(dev).contiguous() for t in (alpha, gamma, El, El_old)]


def compare_kernels(seg, V, K, dev, label):
    """Both kernels against their plain versions on one chunk."""
    import torch

    from topicmodelsvb_jl_torch.kernels.lda_elbo import lda_elbo_tok, lda_elbo_tok_ref
    from topicmodelsvb_jl_torch.kernels.lda_estep import lda_estep, lda_estep_ref
    from topicmodelsvb_jl_torch.utils.numerics import EPSILON, dirichlet_ones

    terms, counts, doc_mask = seg
    B = terms.shape[0]
    g = torch.Generator().manual_seed(11)
    beta = dirichlet_ones(g, V, (K,)).to(dev)
    beta_old = dirichlet_ones(g, V, (K,)).to(dev)
    betaT = (beta + EPSILON).T.contiguous()
    alpha, gamma, El, El_old = warm_state(K, B, dev, seed=12)
    args = (betaT, terms, counts, doc_mask, alpha, gamma, El, El_old)
    kw = dict(viter=10, vtol=1.0 / K**2)

    got = lda_estep(*args, **kw)
    want = lda_estep_ref(*args, **kw)
    torch.cuda.synchronize()
    err_e = 0.0
    for name, a, b in zip(("gamma", "El", "El_old", "w"), got, want):
        need(bool(torch.all(torch.isfinite(a))), f"lda_estep {label}: {name} not finite")
        excess = (a - b).abs() - (1e-5 + 5e-3 * b.abs())
        need(float(excess.max()) <= 0.0,
             f"lda_estep {label}: {name} off by {float((a - b).abs().max())}")
        err_e = max(err_e, float((a - b).abs().max()))
    need(bool(torch.all(got[3][doc_mask == 0] == 0)), f"lda_estep {label}: padded w")
    ms_e = cuda_ms(lambda: lda_estep(*args, **kw), 10)
    plain_e = cuda_ms(lambda: lda_estep_ref(*args, **kw), 5)

    boT = (beta_old + EPSILON).T.contiguous()
    g2T = (boT * (torch.log(beta + EPSILON).T - torch.log(boT))).contiguous()
    eargs = (boT, g2T, terms, counts, doc_mask, El, El_old)
    a, b = float(lda_elbo_tok(*eargs)), float(lda_elbo_tok_ref(*eargs))
    need(abs(a - b) <= 1e-5 * abs(b), f"lda_elbo_tok {label}: {a} vs {b}")
    ms_b = cuda_ms(lambda: lda_elbo_tok(*eargs), 10)
    plain_b = cuda_ms(lambda: lda_elbo_tok_ref(*eargs), 5)
    print(f"kernels {label}: B={B} L={terms.shape[1]} K={K} | lda_estep "
          f"{ms_e:.4f} ms (plain {plain_e:.4f} ms, max abs err {err_e:.3e}) | "
          f"lda_elbo_tok {ms_b:.4f} ms (plain {plain_b:.4f} ms, "
          f"rel err {abs(a - b) / abs(b):.3e})")
    return dict(estep=(err_e, ms_e, plain_e), elbo=(abs(a - b), ms_b, plain_b))


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import topicmodelsvb_jl_torch as tt
    from topicmodelsvb_jl_torch.convert import lda_state_from_numpy, lda_state_to_numpy
    from topicmodelsvb_jl_torch.kernels import _build
    from topicmodelsvb_jl_torch.kernels.lda_elbo import lda_elbo_tok
    from topicmodelsvb_jl_torch.kernels.lda_estep import lda_estep
    from topicmodelsvb_jl_torch.validate import check_model

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. card and build
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip()
    print(smi)
    t0 = time.perf_counter()
    lib = _build.build()
    fit = _build.function("tmvb_lda_estep_rows_in_smem", [ctypes.c_int64] * 2)
    print(f"build: {time.perf_counter() - t0:.1f} s -> {lib.name}")
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "Used" in line or "spill" in line:
            print("ptxas:", line.strip())

    # 2. corpus
    t0 = time.perf_counter()
    packed = tt.synth_packed_nsf_scale(seed=7)
    bucketed = tt.bucketize_packed(packed, chunk=1024, pad_multiple=8)
    K, V = 100, packed.V
    print(f"corpus: M={packed.M} V={V} segments={len(bucketed.segments)} "
          f"widths={[s.L for s in bucketed.segments]} ({time.perf_counter() - t0:.1f} s)")

    # 3. kernel vs plain, then a small model on the card against the CPU
    s0 = bucketed.segments[0]
    put = lambda a, dt: torch.as_tensor(np.ascontiguousarray(a), dtype=dt).to(dev)
    wide = (put(s0.terms[:1024], torch.int32), put(s0.counts[:1024], torch.float32),
            put(s0.doc_mask[:1024], torch.float32))
    r = np.random.default_rng(3)
    n = r.integers(600, 1025, size=1024)
    cnt = (1 + r.poisson(0.35, size=(1024, 1024))) * (np.arange(1024)[None, :] < n[:, None])
    trm = np.minimum((V * r.random((1024, 1024)) ** 3).astype(np.int32), V - 1) * (cnt > 0)
    long_ = (put(trm, torch.int32), put(cnt, torch.float32),
             torch.ones(1024, dtype=torch.float32, device=dev))
    need(fit(s0.L, K) == 1 and fit(1024, K) == 0,
         f"shared-memory rule: L={s0.L} -> {fit(s0.L, K)}, L=1024 -> {fit(1024, K)}")
    res_wide = compare_kernels(wide, V, K, dev, f"widest bucket L={s0.L}")
    res_long = compare_kernels(long_, V, K, dev, "L=1024 rows in device memory")

    small = tt.synth_packed_nsf_scale(M=2000, V=500, mean_terms=30, seed=5)
    gpu = tt.LDA(small, 10, tt.RuntimeConfig(chunk_docs=256), device=dev, seed=1)
    cpu = tt.LDA(small, 10, tt.RuntimeConfig(chunk_docs=256, dtype="float64"),
                 device="cpu", seed=1)
    cpu.state = lda_state_from_numpy(lda_state_to_numpy(gpu.state), "cpu", torch.float64)
    gpu.train(iter=3, checkelbo=1, printelbo=False)
    cpu.train(iter=3, checkelbo=1, printelbo=False)
    ge = [x.elbo for x in gpu.trainer.trace]
    ce = [x.elbo for x in cpu.trainer.trace]
    rel = max(abs(a - b) / abs(b) for a, b in zip(ge, ce))
    need(rel <= 1e-4, f"small model: f32 card ELBO {ge} vs f64 CPU {ce}")
    need(np.allclose(gpu.alpha, cpu.alpha, rtol=1e-3), "small model: alpha")
    need(np.allclose(gpu.beta, cpu.beta, rtol=1e-3, atol=1e-6), "small model: beta")
    print(f"small model (M=2000, K=10, 3 iterations): card f32 vs CPU f64 "
          f"ELBO rel diff {rel:.3e}")

    # 4. main path
    model = tt.LDA(packed, K, runtime=tt.RuntimeConfig(chunk_docs=1024, dtype="float32"),
                   device="cuda", seed=7)
    n_chunks = sum(s.terms.shape[0] for s in model.packed.segments) // model.chunk_docs
    lda_estep.launches = 0
    lda_elbo_tok.launches = 0
    t0 = time.perf_counter()
    model.train(iter=4, checkelbo=1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"lda_estep": lda_estep.launches, "lda_elbo_tok": lda_elbo_tok.launches}
    trace = model.trainer.trace
    need(len(trace) == 4, f"main path ran {len(trace)} of 4 iterations")
    need(all(x.delta_elbo > 0 for x in trace),
         f"∆elbo not positive: {[x.delta_elbo for x in trace]}")
    check_model(model)
    need(launches["lda_estep"] == n_chunks * len(trace),
         f"lda_estep launches {launches['lda_estep']} != {n_chunks} x {len(trace)}")
    need(launches["lda_elbo_tok"] == n_chunks * (len(trace) + 1),
         f"lda_elbo_tok launches {launches['lda_elbo_tok']}")
    gam = model.gamma
    need(gam.shape == (packed.M, K) and np.isfinite(gam).all(), "gamma shape/finite")
    step_s = statistics.median(x.step_time_s for x in trace[1:])
    tr = model.trainer
    state = model.state
    pure = []
    for _ in range(3):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state = tr.step_fn(state, *tr.data)
        torch.cuda.synchronize()
        pure.append(time.perf_counter() - t1)
    elbo_ms = cuda_ms(lambda: tr.elbo_fn(state, *tr.elbo_data), 3)
    print(f"main path: NSF M={packed.M} K={K} chunks={n_chunks} 4 iterations in "
          f"{wall:.2f} s; median step+ELBO {step_s:.4f} s = "
          f"{packed.M / step_s:.0f} docs/s; step alone {statistics.median(pure):.4f} s = "
          f"{packed.M / statistics.median(pure):.0f} docs/s; ELBO pass {elbo_ms:.2f} ms; "
          f"final elbo {model.elbo:.3f}; peak mem "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; card {smi}")

    # 5. determinism
    runs = []
    for _ in range(2):
        m = tt.LDA(model.packed, K, runtime=tt.RuntimeConfig(chunk_docs=1024),
                   device="cuda", seed=7)
        m.train(iter=1, checkelbo=float("inf"), printelbo=False)
        runs.append(m.state)
    for f in ("beta", "alpha", "gamma"):
        need(torch.equal(getattr(runs[0], f), getattr(runs[1], f)),
             f"same-seed steps differ in {f}")
    print("determinism: two same-seed steps bitwise equal in beta, alpha, gamma")

    # 6. results
    rows = []
    for name, key, src, tpu in (
            ("lda_estep", "estep", "lda_estep.cu", "lda_estep.py:157"),
            ("lda_elbo_tok", "elbo", "lda_elbo.cu", "lda_elbo.py:119")):
        (e1, ms, plain), (e2, _, _) = res_wide[key], res_long[key]
        rows.append({"name": name, "route": "cuda",
                     "source": f"topicmodelsvb_jl_torch/kernels/csrc/{src}",
                     "replaces": f"topicmodelsvb_jl_tpu/kernels/{tpu}",
                     "launches": launches[name], "max_abs_err": max(e1, e2),
                     "ms": ms, "plain_ms": plain})
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
