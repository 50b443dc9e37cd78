"""CAVI training driver.

Re-implements the reference's ``train!`` control flow (LDA.jl:161-191)
around a model's (step, elbo) pair:

* one ``step_fn`` call per coordinate-ascent iteration (E-sweep + M-step
  + hyperparameter Newton);
* ``check_elbo`` cadence, ∆elbo print format, and early stopping mirror
  ``check_elbo!`` (modelutils.jl:574-585);
* per-iteration records (elbo, ∆elbo, docs/sec, step time) collected into
  a trace.

Device work is queued asynchronously, so wall time is observable only
where the host waits for the device: at the ELBO checks, whose value
fetch cannot return early, and at the final iteration.  Step timings are
back-filled as the average over each such span.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

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


def _synchronize(state) -> None:
    """Wait for the device that holds ``state``."""
    dev = state.beta.device
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Trainer:
    """Generic CAVI driver over a model's (step, elbo) pair.

    ``step_fn(state, *data) -> state`` runs one full outer iteration;
    ``elbo_fn(state, *elbo_data) -> (2,) tensor`` evaluates the bound
    with the reference's *_old semantics as a compensated (hi, lo) pair.
    """

    def __init__(self, step_fn: Callable, elbo_fn: Callable, data: tuple,
                 elbo_data: Optional[tuple] = None, M: int = 0, C: int = 0,
                 printer: Callable[[str], None] = print):
        self.step_fn = step_fn
        self.elbo_fn = elbo_fn
        self.data = tuple(data)
        self.elbo_data = tuple(elbo_data) if elbo_data is not None else self.data
        self.M = M
        self.C = C   # corpus token count (reference model.C, LDA.jl:31)
        self.printer = printer
        self.trace: List[IterationRecord] = []

    def train(self, state, cfg: TrainConfig, corpus_all_empty: bool = False,
              start_iter: int = 0):
        """Run ``cfg.iter`` outer iterations, numbered globally from
        ``start_iter + 1``."""
        cfg.validate()
        n_iter = 0 if corpus_all_empty else cfg.iter

        # initial bound (reference: `(checkelbo <= iter) && update_elbo!(model)`)
        if cfg.checkelbo <= n_iter:
            state = dataclasses.replace(
                state, elbo=self.elbo_fn(state, *self.elbo_data))

        span_start = time.perf_counter()
        span_recs = []
        k0 = int(start_iter)
        for k in range(k0 + 1, k0 + n_iter + 1):
            state = self.step_fn(state, *self.data)
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
                    if cfg.printelbo:
                        self.printer(f"{k} ∆elbo: {round(delta, 3)}")
                else:
                    sync_t0 = time.perf_counter()
                    _synchronize(state)
                    rec.host_sync_s = time.perf_counter() - sync_t0
                span = time.perf_counter() - span_start
                per = span / len(span_recs)
                for r in span_recs:
                    r.span = len(span_recs)
                    r.step_time_s = per
                    r.docs_per_s = self.M / max(per, 1e-12)
                    r.tokens_per_s = self.C / max(per, 1e-12)
                span_recs = []
                span_start = time.perf_counter()
            self.trace.append(rec)
            if rec.delta_elbo is not None and rec.delta_elbo < cfg.tol:
                break
        return state

    def summary(self) -> Dict[str, float]:
        if not self.trace:
            return {}
        times = np.array([r.step_time_s for r in self.trace])
        steady = times[1:] if len(times) > 1 else times  # drop the first iteration
        mean_step = float(steady.mean()) if steady.size else 0.0
        syncs = [r.host_sync_s for r in self.trace if r.host_sync_s is not None]
        return {
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
