"""Deterministic scatter of the M-step statistic.

The reference makes its OpenCL scatter-adds race-free with a precomputed
inverted index (modelutils.jl:371-397, gpuLDA.jl:170-175), and the JAX
package promises that same-seed runs are bitwise equal.  The port does as
the reference does: the inverted index of each chunk is a
:class:`~..kernels.scatter_rows.ScatterPlan`, built once on the host from
the chunk's ids, and the scatter itself is the ``scatter_rows`` kernel
(CUDA tensors) or its plain version (CPU tensors).  Neither adds with
float atomics, so the order of additions does not depend on scheduling.
"""

from __future__ import annotations

import torch

from ..kernels.scatter_rows import ScatterPlan, scatter_rows


def count_scatter_into(acc: torch.Tensor, weights: torch.Tensor,
                       plan: ScatterPlan) -> torch.Tensor:
    """``acc[ids[t], :] += weights[t, :]`` for every token ``t`` the plan
    keeps, in place; returns ``acc``.

    acc: [V, W]; weights: [T, W] per-token rows, exactly 0 on the slots
    the plan leaves out.  The reference's ``beta_temp[:, terms] += phi .*
    counts'`` (LDA.jl:129-132)."""
    return scatter_rows(acc, weights, plan)
