"""Configuration dataclasses.

The reference has no config system — everything is keyword arguments on
``train!`` with model-aware defaults (LDA.jl:161).  Two dataclasses hold
those knobs:

* :class:`TrainConfig` mirrors the reference ``train!`` kwargs, with the
  same names and defaults (``iter=150, tol=1.0, niter=1000, ntol=1/K²,
  viter=10, vtol=1/K², checkelbo=1, printelbo=True``).
* :class:`RuntimeConfig` holds the execution knobs that have no reference
  counterpart: doc-chunk size, padding multiples, the compute dtype, the
  f64 Elogtheta channel, the mesh's data axis and shape, the per-iteration
  metrics sink, the profiler capture, the peak rate of the MFU figure and
  the auto-checkpoint cadence.  The device is an explicit argument of the
  model, not a config field.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Mirrors reference ``train!`` kwargs (LDA.jl:161)."""

    iter: int = 150
    tol: float = 1.0
    niter: int = 1000
    ntol: Optional[float] = None   # default 1/K² resolved at train time
    viter: int = 10
    vtol: Optional[float] = None   # default 1/K² resolved at train time
    checkelbo: float = 1           # positive int or float('inf')
    printelbo: bool = True

    def resolved(self, K: int) -> "TrainConfig":
        return dataclasses.replace(
            self,
            ntol=self.ntol if self.ntol is not None else 1.0 / K**2,
            vtol=self.vtol if self.vtol is not None else 1.0 / K**2,
        )

    def validate(self) -> None:
        if not all(t >= 0 for t in (self.tol, self.ntol or 0, self.vtol or 0)):
            raise ValueError("tolerance parameters must be nonnegative.")
        if not all(i >= 0 for i in (self.iter, self.niter, self.viter)):
            raise ValueError("iteration parameters must be nonnegative.")
        ok = (self.checkelbo == float("inf")) or (
            float(self.checkelbo).is_integer() and self.checkelbo > 0
        )
        if not ok:
            raise ValueError("checkelbo parameter must be a positive integer or Inf.")


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    """Execution knobs (no reference counterpart)."""

    chunk_docs: int = 1024        # docs per E-step chunk (bounds the [B, L, K] stat rows)
    pad_multiple: int = 64        # token-axis padding multiple of a dense corpus
    bucket_pad: int = 8           # per-segment token-width multiple under bucketing
    # compute dtype, "float32" or "float64": both run on the card and on
    # the CPU for every family (kernels._build.check_dtype)
    dtype: str = "float32"
    # LDA and fLDA: the E-step's per-document gamma -> Elogtheta digamma
    # channel in float64, cast back to the float32 state (the token-level
    # [B, L, K] work stays float32); on the card a mode of the lda_estep
    # and flda_estep kernels.  An accuracy knob, not a default; the other
    # families ignore it, as the JAX package's do
    elogtheta_f64: bool = False
    data_axis: str = "data"       # mesh axis the documents are sharded over
    # mesh axis the tables' storage may be sharded over (tensor
    # parallelism: a step's or a streaming model's ``vocab_axis``); the api
    # models shard over the data axis alone, as the JAX package's do
    vocab_axis: str = "vocab"
    # None → every process on the data axis; else the mesh's shape, whose
    # axes past the first (tensor parallelism) must be 1 until they are ported
    mesh_shape: Optional[tuple] = None
    metrics_path: Optional[str] = None  # JSONL sink: one row per outer iteration
    # torch.profiler capture of `profile_steps` steps from the second
    # outer iteration on, written as a Chrome trace into profile_dir
    profile_dir: Optional[str] = None
    profile_steps: int = 3
    # peak FLOP/s of the MFU figure in Trainer.summary(); None is the
    # model's device's own peak in the state's dtype (engine.
    # device_peak_flops: 0 on the CPU, so no MFU there); 0 disables it
    peak_flops: Optional[float] = None
    # checkpoint every N outer iterations during train() to
    # checkpoint_dir/ckpt_iter{k:06d}; 0 disables
    checkpoint_every: int = 0
    checkpoint_dir: Optional[str] = None
    # cast the per-document state leaves to f16 on the device before the
    # checkpoint's device-to-host copy (half its bytes); a resume from it
    # re-converges instead of reproducing the trace bit for bit
    checkpoint_f16: bool = False
