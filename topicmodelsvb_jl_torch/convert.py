"""Carry model state across packages as NumPy arrays.

``torch.Generator`` and ``jax.random`` draw different numbers from the
same seed, so a comparison between the two packages starts both from one
state: the JAX package's ``LDAState`` fields, read as NumPy arrays, become
this package's :class:`~.models.lda.LDAState`, and back.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .models.lda import LDAState

LDA_FIELDS = tuple(LDAState.__dataclass_fields__)


def lda_state_from_numpy(arrays: Mapping, device, dtype=torch.float32) -> LDAState:
    """``arrays`` maps each LDAState field name to an array (anything
    ``np.asarray`` reads, e.g. a JAX state's ``_asdict()``)."""
    return LDAState(**{
        f: torch.tensor(np.array(arrays[f]), dtype=dtype, device=device)
        for f in LDA_FIELDS})


def lda_state_to_numpy(state: LDAState) -> dict:
    return {f: getattr(state, f).detach().cpu().numpy() for f in LDA_FIELDS}
