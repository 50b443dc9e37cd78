"""User-facing model API.

Mirrors the reference's public surface (src/TopicModelsVB.jl:11-18):
``Model(corp, K)`` constructors, ``train(...)`` with the reference's
kwargs and defaults, and the post-hoc ``topicdist``.  The model runs on
the one device its caller names; nothing chooses a device for the user.

This slice builds models from a :class:`~.ops.packing.PackedCorpus`
only; the ``Corpus`` path comes with the corpus slice.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from .engine import Trainer
from .models import lda as lda_mod
from .ops.packing import PackedCorpus, _round_up, bucketize_packed
from .utils.config import RuntimeConfig, TrainConfig
from .utils.numerics import elbo_value


class TopicModelError(Exception):
    """Mirror of the reference TopicModelError (modelutils.jl:1-5)."""


class TopicModel:
    """Construction and packing shared by the models."""

    _bucketed = False   # length-bucketed token packing

    def __init__(self, corp: PackedCorpus, K: int,
                 runtime: Optional[RuntimeConfig] = None, *, device,
                 seed: int = 0):
        """``corp`` is a :class:`PackedCorpus` (dense, or bucketed for one
        shard); ``device`` is where the state and the data live."""
        if K <= 0:
            raise ValueError("number of topics must be a positive integer.")
        if not isinstance(corp, PackedCorpus):
            raise TypeError("the model takes a PackedCorpus; building from a "
                            f"Corpus is not available yet (got {type(corp)})")

        self.K = int(K)
        self.runtime = runtime if runtime is not None else RuntimeConfig()
        self.device = torch.device(device)
        self.dtype = getattr(torch, self.runtime.dtype)
        self.seed = seed
        self.M, self.V, self.U = corp.M, corp.V, corp.U
        if corp.inv_order is not None:
            # already bucketized: rows are length-permuted and
            # interleaved with padding — index back to doc order
            rows = corp.inv_order[: corp.M]
            self.N = corp.N[rows].tolist()
            self.C = corp.C[rows].tolist()
        else:
            self.N = corp.N[: corp.M].tolist()
            self.C = corp.C[: corp.M].tolist()
        if corp.segments is not None and corp.n_shards != 1:
            raise TopicModelError(
                f"pre-bucketed corpus was laid out for n_shards="
                f"{corp.n_shards}; this model runs on one device, "
                f"re-bucketize with n_shards=1.")
        cand = min(self.runtime.chunk_docs, _round_up(max(1, self.M), 8))
        if corp.segments is not None and corp.chunk:
            # pre-bucketed rows come in multiples of corp.chunk: clamp
            # to a divisor so the chunks tile evenly
            cand = (corp.chunk if cand >= corp.chunk
                    else math.gcd(cand, corp.chunk))
        self.chunk_docs = cand
        self.packed = corp
        if self._bucketed and self.packed.segments is None:
            self.packed = bucketize_packed(
                self.packed, chunk=self.chunk_docs, n_shards=1,
                pad_multiple=min(self.runtime.bucket_pad,
                                 self.runtime.pad_multiple))
        for s in self.packed.segments or ():
            # the kernels index the [V, K] table with these ids unchecked
            if s.terms.size and (s.terms.min() < 0 or s.terms.max() >= self.V):
                raise ValueError(f"term ids must lie in [0, {self.V})")
        self.state = None
        self.trainer: Optional[Trainer] = None
        self.topics: Optional[np.ndarray] = None  # [K, V] 1-based rankings
        self.trained_iters: int = 0
        self._init_state()

    # ── subclass hooks ──
    def _init_state(self):
        raise NotImplementedError

    def _build_trainer(self, cfg: TrainConfig) -> Trainer:
        raise NotImplementedError

    def _finalize(self):
        """Post-train artifacts (topics ranking)."""
        self.topics = lda_mod.topics_ranking(self.state.beta)

    def _data_arrays(self) -> tuple:
        """Per-segment (terms, counts, doc_mask) tensors on the device."""
        segs = self.packed.segments
        put = lambda a, dt: torch.as_tensor(a, dtype=dt).to(self.device)
        return (tuple(put(s.terms, torch.int32) for s in segs),
                tuple(put(s.counts, self.dtype) for s in segs),
                tuple(put(s.doc_mask, self.dtype) for s in segs))

    # ── training (reference train!, LDA.jl:161-191) ──
    def train(
        self,
        iter: int = 150,
        tol: float = 1.0,
        niter: int = 1000,
        ntol: Optional[float] = None,
        viter: int = 10,
        vtol: Optional[float] = None,
        checkelbo: float = 1,
        printelbo: bool = True,
    ):
        cfg = TrainConfig(
            iter=iter, tol=tol, niter=niter, ntol=ntol, viter=viter,
            vtol=vtol, checkelbo=checkelbo, printelbo=printelbo,
        ).resolved(self.K)
        cfg.validate()
        # check_model: every train! entry validates the full variational
        # state (reference modelutils.jl:39-360)
        from .validate import check_model
        check_model(self)
        self.trainer = self._build_trainer(cfg)
        all_empty = all(n == 0 for n in self.N)
        self.state = self.trainer.train(
            self.state, cfg, corpus_all_empty=all_empty,
            start_iter=self.trained_iters)
        if self.trainer.trace:
            self.trained_iters = self.trainer.trace[-1].k
        self._finalize()
        return self

    # ── post-hoc API ──
    @property
    def elbo(self) -> float:
        return elbo_value(self.state.elbo)

    def topicdist(self, d):
        """Topic distribution for doc(s), 1-based index (modelutils.jl:946-984)."""
        scalar = np.isscalar(d)
        idx = np.atleast_1d(np.asarray(d, dtype=np.int64))
        if np.any((idx < 1) | (idx > self.M)):
            raise IndexError("some document indices outside corpus range.")
        out = self._topicdist_rows(self._rows(idx - 1))
        return out[0] if scalar else out

    def _rows(self, doc_idx: np.ndarray) -> np.ndarray:
        """Original 0-based doc indices → packed state rows."""
        if self.packed.inv_order is not None:
            return self.packed.inv_order[doc_idx]
        return doc_idx

    def _doc_rows(self) -> np.ndarray:
        """Packed state rows for docs 1..M in original order."""
        return self._rows(np.arange(self.M, dtype=np.int64))

    def _topicdist_rows(self, rows: np.ndarray) -> np.ndarray:
        raise NotImplementedError


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


class LDA(TopicModel):
    """Latent Dirichlet allocation (reference src/LDA.jl, src/gpuLDA.jl)."""

    _bucketed = True

    def __repr__(self):
        return f"Latent Dirichlet allocation model with {self.K} topics."

    def _init_state(self):
        gen = torch.Generator().manual_seed(self.seed)
        self.state = lda_mod.init(gen, self.packed, self.K, self.dtype,
                                  self.device)

    def _build_trainer(self, cfg: TrainConfig) -> Trainer:
        p = self.packed
        step = lda_mod.make_step(
            p, self.K, viter=cfg.viter, vtol=cfg.vtol, niter=cfg.niter,
            ntol=cfg.ntol, chunk_docs=self.chunk_docs)
        elbo = lda_mod.make_elbo(p, self.K, chunk_docs=self.chunk_docs)
        data = self._data_arrays()
        return Trainer(step, elbo, data + (float(self.M),), data,
                       M=self.M, C=int(sum(self.C)))

    # alpha/beta/gamma accessors (reference field access)
    @property
    def alpha(self) -> np.ndarray:
        return _host(self.state.alpha)

    @property
    def beta(self) -> np.ndarray:
        return _host(self.state.beta)

    @property
    def gamma(self) -> np.ndarray:
        return _host(self.state.gamma)[self._doc_rows()]

    @property
    def Elogtheta(self) -> np.ndarray:
        return _host(self.state.Elogtheta)[self._doc_rows()]

    def _topicdist_rows(self, rows: np.ndarray) -> np.ndarray:
        return _host(lda_mod.topicdist(self.state, torch.as_tensor(rows)))
