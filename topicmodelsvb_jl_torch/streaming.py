"""Streaming helpers.

For now the slice assignment that the JAX package's streaming DTM and
``api.DTM`` share; the ``Streaming*`` models come with their own slice.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np


def slices_from_stamps(stamps, delta: float, M_pad: Optional[int] = None):
    """Reference slice assignment (v0.6/src/DTM.jl:58-63): documents with
    stamp ≤ t0 + t·delta land in slice t.  Returns ``(T, slice_id)``,
    ``slice_id`` 0-based int32 of length ``M_pad`` (default: one per
    stamp); padding rows get slice 0 (their doc_mask is 0)."""
    stamps = np.asarray(stamps, np.float64)
    if stamps.size == 0 or not np.all(np.isfinite(stamps)):
        raise ValueError("every document must carry a finite stamp.")
    t0, tM = float(stamps.min()), float(stamps.max())
    T = max(1, int(math.ceil((tM - t0) / float(delta))))
    sid = np.clip(np.ceil((stamps - t0) / float(delta)).astype(np.int64), 1, T) - 1
    out = np.zeros(M_pad if M_pad is not None else len(stamps), np.int32)
    out[: len(stamps)] = sid
    return T, out
