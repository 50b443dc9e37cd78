"""Deterministic scatter of the M-step statistic.

The reference makes its OpenCL scatter-adds race-free with a precomputed
inverted index (modelutils.jl:371-397, gpuLDA.jl:170-175), and the JAX
package promises that same-seed runs are bitwise equal.  Each device
gets the scatter whose order of additions does not depend on scheduling,
without turning on PyTorch's process-wide deterministic mode:

* CUDA: ``index_add_`` accumulates with atomics in an order that changes
  from run to run; ``index_put_(..., accumulate=True)`` takes PyTorch's
  sort-based path instead — a stable sort of the ids, then each run of
  equal ids summed in order.  ``chip_smoke.py`` confirms the bitwise
  repeat on the card.
* CPU: ``index_put_(..., accumulate=True)`` on f32 adds with atomics
  across threads once the scatter is large; ``index_add_`` adds the rows
  serially in token order.
"""

from __future__ import annotations

import torch


def count_scatter_into(acc: torch.Tensor, weights: torch.Tensor,
                       ids: torch.Tensor) -> torch.Tensor:
    """``acc[ids[t], :] += weights[t, :]`` for every token ``t``, in place.

    acc: [V, K]; weights: [T, K] per-token rows; ids: [T] 0-based vocab
    ids.  The reference's ``beta_temp[:, terms] += phi .* counts'``
    (LDA.jl:129-132).  Returns ``acc``.
    """
    if acc.device.type == "cuda":
        return acc.index_put_((ids,), weights, accumulate=True)
    return acc.index_add_(0, ids, weights)
