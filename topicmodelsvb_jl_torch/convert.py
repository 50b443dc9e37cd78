"""Carry model state across packages as NumPy arrays.

``torch.Generator`` and ``jax.random`` draw different numbers from the
same seed, so a comparison between the two packages starts both from one
state: the JAX package's state fields, read as NumPy arrays by name,
become this package's state dataclass, and back; a streaming model's
globals, host arrays and counters go across by :func:`streaming_from`.
:func:`state_for` gives a model sharded over processes its own rows of a
whole state, such as the JAX package's state on an n-device mesh, and
:func:`shard_state` gives a process its blocks of a whole state on any
mesh: document rows, the vocab- and user-axis blocks of tensor
parallelism, and the sequence axis's tau columns.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .models.ctm import CTMState
from .models.ctpf import CTPFState
from .models.dtm import DTMState
from .models.fctm import FCTMState
from .models.flda import FLDAState
from .models.hmtm import HMTMState
from .models.lda import LDAState
from .parallel.mesh import local_block, put_replicated

LDA_FIELDS = tuple(LDAState.__dataclass_fields__)
FLDA_FIELDS = tuple(FLDAState.__dataclass_fields__)
CTPF_FIELDS = tuple(CTPFState.__dataclass_fields__)
CTM_FIELDS = tuple(CTMState.__dataclass_fields__)
FCTM_FIELDS = tuple(FCTMState.__dataclass_fields__)
DTM_FIELDS = tuple(DTMState.__dataclass_fields__)
HMTM_FIELDS = tuple(HMTMState.__dataclass_fields__)


def _from_numpy(cls, arrays: Mapping, device, dtype):
    return cls(**{f: torch.tensor(np.array(arrays[f]), dtype=dtype, device=device)
                  for f in cls.__dataclass_fields__})


def _to_numpy(state) -> dict:
    return {f: getattr(state, f).detach().cpu().numpy()
            for f in type(state).__dataclass_fields__}


def lda_state_from_numpy(arrays: Mapping, device, dtype=torch.float32) -> LDAState:
    """``arrays`` maps each LDAState field name to an array (anything
    ``np.asarray`` reads, e.g. a JAX state's ``_asdict()``)."""
    return _from_numpy(LDAState, arrays, device, dtype)


def lda_state_to_numpy(state: LDAState) -> dict:
    return _to_numpy(state)


def flda_state_from_numpy(arrays: Mapping, device, dtype=torch.float32) -> FLDAState:
    """As :func:`lda_state_from_numpy`, for the 12 FLDAState fields."""
    return _from_numpy(FLDAState, arrays, device, dtype)


def flda_state_to_numpy(state: FLDAState) -> dict:
    return _to_numpy(state)


def ctpf_state_from_numpy(arrays: Mapping, device, dtype=torch.float32) -> CTPFState:
    """As :func:`lda_state_from_numpy`, for the 17 CTPFState fields."""
    return _from_numpy(CTPFState, arrays, device, dtype)


def ctpf_state_to_numpy(state: CTPFState) -> dict:
    return _to_numpy(state)


def ctm_state_from_numpy(arrays: Mapping, device, dtype=torch.float32) -> CTMState:
    """As :func:`lda_state_from_numpy`, for the 10 CTMState fields."""
    return _from_numpy(CTMState, arrays, device, dtype)


def ctm_state_to_numpy(state: CTMState) -> dict:
    return _to_numpy(state)


def fctm_state_from_numpy(arrays: Mapping, device, dtype=torch.float32) -> FCTMState:
    """As :func:`lda_state_from_numpy`, for the 15 FCTMState fields."""
    return _from_numpy(FCTMState, arrays, device, dtype)


def fctm_state_to_numpy(state: FCTMState) -> dict:
    return _to_numpy(state)


def dtm_state_from_numpy(arrays: Mapping, device, dtype=torch.float32) -> DTMState:
    """As :func:`lda_state_from_numpy`, for the 9 DTMState fields."""
    return _from_numpy(DTMState, arrays, device, dtype)


def dtm_state_to_numpy(state: DTMState) -> dict:
    return _to_numpy(state)


def hmtm_state_from_numpy(arrays: Mapping, device, dtype=torch.float32) -> HMTMState:
    """As :func:`lda_state_from_numpy`, for the 6 HMTMState fields."""
    return _from_numpy(HMTMState, arrays, device, dtype)


def hmtm_state_to_numpy(state: HMTMState) -> dict:
    return _to_numpy(state)



# each state's fields that shard over the mesh: per-document rows (over
# the data axes), and (field: dim) of the vocab-, user- and sequence-axis
# blocks, as the JAX package's partition_spec functions lay them out
# (fLDA's and fCTM's per-token tau: P(data, seq))
LAYOUT = {
    LDAState: dict(doc=("gamma", "Elogtheta", "Elogtheta_old"),
                   vocab={"beta": 1, "beta_old": 1}),
    FLDAState: dict(doc=("gamma", "Elogtheta", "Elogtheta_old", "tau", "tau_old"),
                    vocab={"beta": 1, "beta_old": 1, "kappa": 0, "kappa_old": 0},
                    seq={"tau": 1, "tau_old": 1}),
    CTMState: dict(doc=("lam", "lam_old", "vsq", "logzeta"),
                   vocab={"beta": 1, "beta_old": 1}),
    FCTMState: dict(doc=("lam", "lam_old", "vsq", "logzeta", "tau", "tau_old"),
                    vocab={"beta": 1, "beta_old": 1, "kappa": 0, "kappa_old": 0},
                    seq={"tau": 1, "tau_old": 1}),
    CTPFState: dict(doc=("gimel", "gimel_old", "zayin", "zayin_old"),
                    vocab={"alef": 1, "alef_old": 1}, user={"he": 1, "he_old": 1}),
    DTMState: dict(doc=("gamma", "Elogtheta", "lzeta"),
                   vocab={"betahat": 2, "mbeta": 2, "vbeta": 2, "v_filt": 2}),
    HMTMState: dict(doc=("tau", "gamma"), vocab={"beta": 1}),
}


def shard_state(cls, arrays: Mapping, mesh, *, data_axis="data", vocab_axis=None,
                user_axis=None, seq_axis=None, device="cpu", dtype=torch.float32):
    """This process's blocks of a whole state of ``cls`` (each field by
    name, as the JAX package holds it): the per-document fields' rows over
    ``data_axis`` (a name or a tuple of names, the first major, JAX's
    ``P(("data", "vocab"))`` order), the vocab-sharded fields' columns by
    vocab coordinate (beta ``[K, V/n]``, kappa ``[V/n]``, DTM's
    ``[T, K, V/n]``), CTPF's he by user coordinate, fLDA's and fCTM's tau
    columns by ``seq_axis`` coordinate (``[rows, L/n]``), every other
    field whole; on ``device`` in ``dtype``."""
    lay = LAYOUT[cls]
    kw = dict(device=device, dtype=dtype)
    out = {}
    for f in cls.__dataclass_fields__:
        a = np.asarray(arrays[f])
        if f in lay["doc"]:
            a = local_block(a, mesh, data_axis)
        for key, axis in (("vocab", vocab_axis), ("user", user_axis), ("seq", seq_axis)):
            if axis is not None and f in lay.get(key, {}):
                a = local_block(a, mesh, axis, dim=lay[key][f])
        out[f] = put_replicated(a, **kw)
    return cls(**out)


def state_for(model, arrays: Mapping, dtype=None):
    """The state of an api ``model`` from the arrays of a whole state
    (each field by name, per-document fields in shard-major packed rows,
    as the JAX package holds them on a mesh of as many devices as the
    model's data axis has shards): this process's rows of every
    per-document field, every global whole, on the model's device, in
    ``dtype`` (default the model's).  The api models shard over the data
    axis alone (:func:`shard_state` takes the other axes)."""
    return shard_state(type(model.state), arrays, model.mesh,
                       data_axis=model.runtime.data_axis, device=model.device,
                       dtype=dtype or model.dtype)


def streaming_from(model, src):
    """Set a streaming model's globals, host per-document arrays and
    counters from ``src``, the same-family streaming model of either
    package.  The names are the model's ``_globals``, ``_doc_state`` and
    ``_counters``, which are the JAX package's.  Returns ``model``."""
    def get(n):
        v = getattr(src, n)
        return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v

    for n in model._globals:
        setattr(model, n, torch.tensor(np.array(get(n)), dtype=model.dtype,
                                       device=model.device))
    for n in model._doc_state:
        getattr(model, n)[...] = np.asarray(get(n))
    for n in model._counters:
        setattr(model, n, get(n))
    return model
