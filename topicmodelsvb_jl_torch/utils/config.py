"""Configuration dataclasses.

The reference has no config system — everything is keyword arguments on
``train!`` with model-aware defaults (LDA.jl:161).  Two dataclasses hold
those knobs:

* :class:`TrainConfig` mirrors the reference ``train!`` kwargs, with the
  same names and defaults (``iter=150, tol=1.0, niter=1000, ntol=1/K²,
  viter=10, vtol=1/K², checkelbo=1, printelbo=True``).
* :class:`RuntimeConfig` holds the execution knobs that have no reference
  counterpart: doc-chunk size, padding multiples and the compute dtype.
  The device is an explicit argument of the model, not a config field.
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
    dtype: str = "float32"        # compute dtype; "float64" for the CPU oracle
