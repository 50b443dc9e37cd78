"""CAVI training driver.

Re-implements the reference's ``train!`` control flow (LDA.jl:161-191)
around a model's (step, elbo) pair:

* one ``step_fn`` call per coordinate-ascent iteration (E-sweep + M-step
  + hyperparameter Newton);
* ``check_elbo`` cadence, ∆elbo print format, and early stopping mirror
  ``check_elbo!`` (modelutils.jl:574-585);
* per-iteration records (elbo, ∆elbo, docs/sec, step time) collected into
  a trace, and written as JSONL rows to ``metrics_path`` when one is set;
* ``checkpoint_cb(k, state)`` every ``checkpoint_every`` outer iterations,
  its wall time kept out of the step timings;
* on a model sharded over processes, every process runs the same loop:
  the bound is reduced over them, so the trace and the stop test agree
  bit for bit, and only the ``main`` process prints and writes JSONL;
* an optional ``torch.profiler`` capture of ``profile_steps`` steps from
  the second iteration on, each step marked ``cavi_step``, written as a
  Chrome trace into ``profile_dir`` by the main process;
* the step's arithmetic (``flops_per_step``, the models' estimate) over
  its time and the device's peak (``peak_flops``,
  :func:`device_peak_flops`): ``tflops_per_s`` and ``mfu`` in the summary;
* :class:`HostReads`, a counter of the values a block of code reads back
  to the host, each of which waits for the device.

Device work is queued asynchronously, so wall time is observable only
where the host waits for the device: at the ELBO checks, whose value
fetch cannot return early, and at the final iteration.  Step timings are
back-filled as the average over each such span.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import subprocess
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from .utils.config import TrainConfig
from .utils.numerics import elbo_value


@dataclasses.dataclass
class IterationRecord:
    k: int
    step_time_s: float
    docs_per_s: float
    tokens_per_s: float = 0.0
    elbo: Optional[float] = None
    delta_elbo: Optional[float] = None
    host_sync_s: Optional[float] = None
    # step_time_s/docs_per_s/tokens_per_s are the AVERAGE over the `span`
    # iterations ending at this row's sync (span=1 under checkelbo=1)
    span: int = 1


def _synchronize(state, device=None) -> None:
    """Wait for ``device``, or else for the device of the state's first
    tensor field."""
    if device is None:
        device = next(v.device for v in (getattr(state, f.name)
                                          for f in dataclasses.fields(state))
                      if isinstance(v, torch.Tensor))
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _max_sm_clock_hz(index: int) -> float:
    """The card's maximum SM clock from ``nvidia-smi`` (by the device's
    UUID, which survives ``CUDA_VISIBLE_DEVICES``, else by its index); 0
    if it does not say."""
    uuid = getattr(torch.cuda.get_device_properties(index), "uuid", None)
    for ident in ([f"GPU-{uuid}"] if uuid else []) + [str(index)]:
        try:
            out = subprocess.run(
                ["nvidia-smi", "-i", ident, "--query-gpu=clocks.max.sm",
                 "--format=csv,noheader,nounits"],
                capture_output=True, text=True, timeout=30)
            return float(out.stdout.strip().splitlines()[0]) * 1e6
        except (OSError, subprocess.SubprocessError, ValueError, IndexError):
            continue
    return 0.0


# FMA lanes an SM on Hopper, the one architecture the kernels build for:
# 128 f32 lanes and 64 FP64 lanes (the f64 rate is half the f32 rate)
_LANES = {"float32": 128, "float64": 64}


@functools.lru_cache(maxsize=None)
def _cuda_peak_flops(index: int, lanes: int) -> float:
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return sms * lanes * 2.0 * _max_sm_clock_hz(index)


def device_peak_flops(device, dtype=torch.float32) -> float:
    """Peak FLOP/s of ``device`` outside the tensor cores in ``dtype``
    (float32 or float64): SMs × lanes × 2 (an FMA) × the maximum SM clock,
    with 128 f32 lanes or 64 FP64 lanes an SM (an H100 SXM: 132 × 128 × 2 ×
    1.98 GHz = 66.9 TFLOP/s in f32, 33.5 TFLOP/s in f64).  0 for a CPU
    (no MFU figure)."""
    device = torch.device(device)
    if device.type != "cuda":
        return 0.0
    name = str(dtype).replace("torch.", "")
    if name not in _LANES:
        raise ValueError(f"no peak rate for {name}")
    index = device.index if device.index is not None else torch.cuda.current_device()
    return _cuda_peak_flops(index, _LANES[name])


class HostReads(TorchDispatchMode):
    """Counts, in ``n``, the values read back to the host
    (``aten._local_scalar_dense``: ``bool``/``float``/``item`` of a
    tensor) while the mode is entered."""

    n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten._local_scalar_dense.default:
            self.n += 1
        return func(*args, **(kwargs or {}))


class Trainer:
    """Generic CAVI driver over a model's (step, elbo) pair.

    ``step_fn(state, *data) -> state`` runs one full outer iteration;
    ``elbo_fn(state, *elbo_data) -> (2,) tensor`` evaluates the bound
    with the reference's *_old semantics as a compensated (hi, lo) pair.
    ``device``, when given, is the device the end-of-run wait is for, and
    a CUDA device's activity is captured beside the CPU's when profiling.
    ``flops_per_step`` and ``peak_flops`` give the summary its
    ``tflops_per_s`` and ``mfu``.  ``main=False`` silences the printer,
    the JSONL sink and the profiler (every process but the first of a
    data axis).
    """

    def __init__(self, step_fn: Callable, elbo_fn: Callable, data: tuple,
                 elbo_data: Optional[tuple] = None, M: int = 0, C: int = 0,
                 flops_per_step: float = 0.0, peak_flops: float = 0.0,
                 printer: Callable[[str], None] = print, device=None,
                 metrics_path: Optional[str] = None,
                 profile_dir: Optional[str] = None, profile_steps: int = 3,
                 checkpoint_cb: Optional[Callable] = None, checkpoint_every: int = 0,
                 main: bool = True):
        self.step_fn = step_fn
        self.elbo_fn = elbo_fn
        self.data = tuple(data)
        self.elbo_data = tuple(elbo_data) if elbo_data is not None else self.data
        self.M = M
        self.C = C   # corpus token count (reference model.C, LDA.jl:31)
        self.flops_per_step = flops_per_step
        self.peak_flops = peak_flops
        self.printer = printer
        self.device = device
        self.trace: List[IterationRecord] = []
        self.metrics_path = metrics_path
        self.profile_dir = profile_dir
        self.profile_steps = int(profile_steps)
        self.checkpoint_cb = checkpoint_cb
        self.checkpoint_every = int(checkpoint_every)
        self.main = bool(main)

    def train(self, state, cfg: TrainConfig, corpus_all_empty: bool = False,
              start_iter: int = 0):
        """Run ``cfg.iter`` outer iterations, numbered globally from
        ``start_iter + 1``: a resumed run continues the iteration counter,
        so its JSONL rows and checkpoint names never collide with the
        first run's."""
        cfg.validate()
        n_iter = 0 if corpus_all_empty else cfg.iter

        # initial bound (reference: `(checkelbo <= iter) && update_elbo!(model)`)
        if cfg.checkelbo <= n_iter:
            state = dataclasses.replace(
                state, elbo=self.elbo_fn(state, *self.elbo_data))

        span_start = time.perf_counter()
        span_recs = []
        k0 = int(start_iter)
        prof, prof_from = None, 0
        try:
            for k in range(k0 + 1, k0 + n_iter + 1):
                if self.profile_dir and self.main and k == k0 + 2:   # past the first step
                    prof, prof_from = self._start_profile(), k
                with torch.profiler.record_function("cavi_step"):
                    state = self.step_fn(state, *self.data)
                if prof is not None and k >= k0 + 1 + self.profile_steps:
                    _synchronize(state, self.device)
                    done, prof = prof, None
                    self._stop_profile(done, prof_from, k)
                rec = IterationRecord(k=k, step_time_s=0.0, docs_per_s=0.0)
                span_recs.append(rec)

                # check_elbo! (modelutils.jl:574-585)
                sync = cfg.checkelbo != float("inf") and k % int(cfg.checkelbo) == 0
                if sync or k == k0 + n_iter:
                    if sync:
                        new_elbo = self.elbo_fn(state, *self.elbo_data)
                        sync_t0 = time.perf_counter()
                        # combine the (hi, lo) pair in f64 on the host so
                        # ∆elbo keeps sub-ulp(total) resolution (fetch = sync)
                        new_val = elbo_value(new_elbo)
                        delta = new_val - elbo_value(state.elbo)
                        rec.host_sync_s = time.perf_counter() - sync_t0
                        state = dataclasses.replace(state, elbo=new_elbo)
                        rec.elbo, rec.delta_elbo = new_val, delta
                        if cfg.printelbo and self.main:
                            self.printer(f"{k} ∆elbo: {round(delta, 3)}")
                    else:
                        sync_t0 = time.perf_counter()
                        _synchronize(state, self.device)
                        rec.host_sync_s = time.perf_counter() - sync_t0
                    span = time.perf_counter() - span_start
                    per = span / len(span_recs)
                    for r in span_recs:
                        r.span = len(span_recs)
                        r.step_time_s = per
                        r.docs_per_s = self.M / max(per, 1e-12)
                        r.tokens_per_s = self.C / max(per, 1e-12)
                        self._emit(r)   # once its timings are real
                    span_recs = []
                    span_start = time.perf_counter()
                self.trace.append(rec)
                if (self.checkpoint_cb is not None and self.checkpoint_every > 0
                        and k % self.checkpoint_every == 0):
                    # the callback's wall time does not count toward the
                    # back-filled step timings; the device work queued before
                    # it does, so an open span waits for it first
                    if span_recs:
                        _synchronize(state, self.device)
                    cb_t0 = time.perf_counter()
                    self.checkpoint_cb(k, state)
                    span_start += time.perf_counter() - cb_t0
                if rec.delta_elbo is not None and rec.delta_elbo < cfg.tol:
                    break
        except BaseException:
            if prof is not None:   # close the capture; a failed run writes no trace
                prof.stop()
            raise
        if prof is not None:   # the run ended before profile_steps steps
            _synchronize(state, self.device)
            self._stop_profile(prof, prof_from, self.trace[-1].k)
        return state

    def _start_profile(self):
        """A started ``torch.profiler`` capture: CPU activity, and CUDA
        activity on a CUDA device."""
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device is not None and torch.device(self.device).type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts, acc_events=True)   # one capture, one cycle
        prof.start()
        return prof

    def _stop_profile(self, prof, first: int, last: int) -> None:
        """Stop the capture and write it into ``profile_dir`` as
        ``trace_iter{first:06d}-{last:06d}.json`` (Chrome trace format)."""
        prof.stop()
        os.makedirs(self.profile_dir, exist_ok=True)
        prof.export_chrome_trace(
            os.path.join(self.profile_dir, f"trace_iter{first:06d}-{last:06d}.json"))

    def _emit(self, rec: IterationRecord) -> None:
        if not self.metrics_path or not self.main:
            return
        with open(self.metrics_path, "a") as f:
            f.write(json.dumps(dataclasses.asdict(rec)) + "\n")

    def summary(self) -> Dict[str, float]:
        """Step time, rates and the final bound over the trace; with
        ``flops_per_step``, ``tflops_per_s``, and with ``peak_flops`` the
        ``mfu`` (the JAX package's keys)."""
        if not self.trace:
            return {}
        times = np.array([r.step_time_s for r in self.trace])
        steady = times[1:] if len(times) > 1 else times  # drop the first iteration
        mean_step = float(steady.mean()) if steady.size else 0.0
        syncs = [r.host_sync_s for r in self.trace if r.host_sync_s is not None]
        out = {
            "iterations": len(self.trace),
            "mean_step_s": mean_step,
            "docs_per_s": float(self.M / mean_step) if mean_step else 0.0,
            "tokens_per_s": float(self.C / mean_step) if mean_step else 0.0,
            "host_sync_s_total": float(np.sum(syncs)) if syncs else 0.0,
            "total_s": float(times.sum()),
            "final_elbo": next(
                (r.elbo for r in reversed(self.trace) if r.elbo is not None), None
            ),
        }
        if self.flops_per_step and mean_step:
            out["flops_per_step"] = self.flops_per_step
            out["tflops_per_s"] = self.flops_per_step / mean_step / 1e12
            if self.peak_flops:
                out["mfu"] = self.flops_per_step / mean_step / self.peak_flops
        return out
