"""User-facing model API.

Mirrors the reference's public surface (src/TopicModelsVB.jl:11-18):
``Model(corp, K)`` constructors, ``train(...)`` with the reference's
kwargs and defaults, and the post-hoc ``topicdist``.  The model runs on
the one device its caller names; nothing chooses a device for the user.

This slice builds models from a :class:`~.ops.packing.PackedCorpus`
only; the ``Corpus`` path (and with it ``showlibs``/``showdrecs``/
``showurecs`` and ``warm_start_from``) comes with the corpus slice.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from .corpus import CorpusError
from .engine import Trainer
from .models import ctm as ctm_mod
from .models import ctpf as ctpf_mod
from .models import fctm as fctm_mod
from .models import flda as flda_mod
from .models import lda as lda_mod
from .ops.packing import PackedCorpus, _round_up, bucketize_packed
from .utils.config import RuntimeConfig, TrainConfig
from .utils.numerics import elbo_value


class TopicModelError(Exception):
    """Mirror of the reference TopicModelError (modelutils.jl:1-5)."""


class TopicModel:
    """Construction and packing shared by the models."""

    _uses_readers = False
    _bucketed = False   # length-bucketed token packing
    # chunk_docs when the caller passes no RuntimeConfig, as in the JAX
    # package (api.py:52-55): the Newton-heavy CTM and fCTM take 2048
    _preferred_chunk = 1024

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
        self.runtime = (runtime if runtime is not None
                        else RuntimeConfig(chunk_docs=self._preferred_chunk))
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
        if self._uses_readers and (corp.readers is None or corp.ratings is None
                                   or corp.R is None):
            raise ValueError("this model requires reader arrays (readers, ratings, R) "
                             "in the packed corpus.")
        if self._bucketed and self.packed.segments is None:
            self.packed = bucketize_packed(
                self.packed, chunk=self.chunk_docs, n_shards=1,
                pad_multiple=min(self.runtime.bucket_pad,
                                 self.runtime.pad_multiple))
        for s in self.packed.segments or ():
            # the kernels index the [V, K] table with these ids unchecked
            if s.terms.size and (s.terms.min() < 0 or s.terms.max() >= self.V):
                raise ValueError(f"term ids must lie in [0, {self.V})")
        r = self.packed.readers
        if self._uses_readers and r.size and (r.min() < 0 or r.max() >= max(self.U, 1)):
            raise ValueError(f"reader ids must lie in [0, {max(self.U, 1)})")
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
        self.topics = lda_mod.topics_ranking(self._topic_word_matrix())

    def _topic_word_matrix(self) -> torch.Tensor:
        return self.state.beta

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
            raise CorpusError("some document indices outside corpus range.")
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


class _DirichletAccessors:
    """alpha/beta/gamma/Elogtheta field access (reference field access) and
    topicdist, shared by LDA and fLDA."""

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


class LDA(_DirichletAccessors, TopicModel):
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
            ntol=cfg.ntol, chunk_docs=self.chunk_docs, device=self.device)
        elbo = lda_mod.make_elbo(p, self.K, chunk_docs=self.chunk_docs)
        data = self._data_arrays()
        return Trainer(step, elbo, data + (float(self.M),), data,
                       M=self.M, C=int(sum(self.C)), device=self.device)


class fLDA(_DirichletAccessors, TopicModel):
    """Filtered LDA (reference src/fLDA.jl)."""

    _bucketed = True

    def __repr__(self):
        return f"Filtered latent Dirichlet allocation model with {self.K} topics."

    def _init_state(self):
        gen = torch.Generator().manual_seed(self.seed)
        self.state = flda_mod.init(gen, self.packed, self.K, self.dtype,
                                   self.device)

    def _build_trainer(self, cfg: TrainConfig) -> Trainer:
        p = self.packed
        step = flda_mod.make_step(
            p, self.K, viter=cfg.viter, vtol=cfg.vtol, niter=cfg.niter,
            ntol=cfg.ntol, chunk_docs=self.chunk_docs, device=self.device)
        elbo = flda_mod.make_elbo(p, self.K, chunk_docs=self.chunk_docs)
        data = self._data_arrays()
        C = sum(self.C)
        # M_total and C_total stay on the device, like eta
        totals = tuple(torch.tensor(float(x), dtype=self.dtype, device=self.device)
                       for x in (self.M, C))
        return Trainer(step, elbo, data + totals, data, M=self.M, C=int(C),
                       device=self.device)

    @property
    def eta(self) -> float:
        return float(self.state.eta)

    @property
    def kappa(self) -> np.ndarray:
        return _host(self.state.kappa)

    @property
    def tau(self):
        """Ragged view: list of per-doc tau vectors (reference fLDA.jl:25)."""
        t = _host(self.state.tau)
        rows = self._doc_rows()
        return [t[rows[d], : self.N[d]] for d in range(self.M)]


class _LazyRecs:
    """Sequence view over ranked recommendations (reference drecs/urecs,
    CTPF.jl:377-400): each row is ranked on first access instead of
    materialising the full M·U ranking."""

    def __init__(self, model, kind: str, n: int):
        self._model = model
        self._kind = kind
        self._n = n

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(self._n))]
        if i < 0:
            i += self._n
        if not 0 <= i < self._n:
            raise IndexError(i)
        return self._model._rec_row(self._kind, i)

    def __iter__(self):
        return (self[i] for i in range(self._n))

    def __repr__(self):
        return f"<lazy {'doc' if self._kind == 'd' else 'user'} recs, {self._n} rows>"


class CTPF(TopicModel):
    """Collaborative topic Poisson factorization (reference src/CTPF.jl).

    Adds the recommender surface: user libraries (``libs``), ranked
    per-document user recommendations (``drecs``) and per-user document
    recommendations (``urecs``) (reference CTPF.jl:62-79, 377-400).
    """

    _uses_readers = True
    _bucketed = True
    # past this many M·U elements the dense score matrix is never built
    # (not even on the device): ranked rec rows come from O((M+U)·K)
    # matrix-vector products against the factor state instead
    _SCORES_DENSE_MAX = 100_000_000

    def __init__(self, corp: PackedCorpus, K: int,
                 runtime: Optional[RuntimeConfig] = None, *, device, seed: int = 0):
        super().__init__(corp, K, runtime, device=device, seed=seed)
        # R and the user libraries (CTPF.jl:62-65, 1-based doc indices)
        # from the reader arrays: 0-based user ids, rows permuted by packing
        rows = self._doc_rows()
        p = self.packed
        self.R = p.R[rows].tolist()
        self.libs = [[] for _ in range(self.U)]
        if self.U > 0:
            for d, row in enumerate(rows, start=1):
                for u in p.readers[row, : p.R[row]]:
                    self.libs[int(u)].append(d)
        # after training the scores live on the device ([M, U] is 100s of
        # MB at scale) and reach the host a row at a time, or (past
        # _SCORES_DENSE_MAX) each row is a product of its own; recs
        # (unranked complements before training, score-ranked after) are
        # lazy per-row views
        self._scores_dev = None
        self._lazy_scores = False
        self._scores_np = None

    def __repr__(self):
        return f"Collaborative topic Poisson factorization model with {self.K} topics."

    @property
    def scores(self) -> np.ndarray:
        if self._scores_np is None:
            if self._scores_dev is not None:
                self._scores_np = _host(self._scores_dev)
            elif self._lazy_scores:
                # an explicit ask for the full matrix: build it once
                s = ctpf_mod.scores(self.state)
                rows = torch.as_tensor(self._doc_rows(), device=self.device)
                self._scores_np = _host(s[rows][:, : self.U])
            else:
                self._scores_np = np.zeros((self.M, self.U))
        return self._scores_np

    def _score_slice(self, kind: str, i: int) -> np.ndarray:
        if self._scores_np is not None:
            return self._scores_np[i] if kind == "d" else self._scores_np[:, i]
        if self._scores_dev is not None:
            return _host(self._scores_dev[i] if kind == "d" else self._scores_dev[:, i])
        return self._score_row_dev(kind, i)

    def _score_row_dev(self, kind: str, i: int) -> np.ndarray:
        """One row of Eeta'·(Etheta+Eepsilon) (CTPF.jl:381-386) as an
        O((M+U)·K) product on the device; the dense [M, U] never exists."""
        st = self.state
        rows = self._doc_rows()
        if kind == "d":   # users scored for document i: [U]
            r = int(rows[i])
            v = st.gimel[r] / st.dalet + st.zayin[r] / st.het     # [K]
            return _host((v @ (st.he / st.vav[:, None]))[: self.U])
        # documents scored for user i: [M], in doc order
        eeta_i = st.he[:, i] / st.vav                             # [K]
        s = (st.gimel / st.dalet[None, :] + st.zayin / st.het[None, :]) @ eeta_i
        return _host(s)[rows]

    def _rec_row(self, kind: str, i: int) -> list:
        """Ranked recommendation row (0-based i), computed on demand."""
        if kind == "d":   # users for document i
            n = self.U
            p = self.packed
            row = int(self._rows(i))
            excl = p.readers[row, : p.R[row]].astype(np.int64) + 1
        else:             # documents for user i
            n = self.M
            excl = np.asarray(self.libs[i], dtype=np.int64)
        if n and (self._scores_dev is not None or self._lazy_scores):
            order = np.argsort(-self._score_slice(kind, i), kind="stable")
        else:
            order = np.arange(n, dtype=np.int64)
        mask = np.ones(n, dtype=bool)
        if excl.size:
            mask[excl - 1] = False
        return (order[mask[order]] + 1).tolist()

    @property
    def urecs(self):
        return _LazyRecs(self, "u", self.U)

    @property
    def drecs(self):
        return _LazyRecs(self, "d", self.M)

    def _init_state(self):
        gen = torch.Generator().manual_seed(self.seed)
        self.state = ctpf_mod.init(gen, self.packed, self.K, self.dtype,
                                   self.device)

    def _step_data(self) -> tuple:
        """(terms, counts, readers, ratings, doc_mask): per-segment token
        tuples and the dense reader arrays, on the device."""
        terms, counts, doc_mask = self._data_arrays()
        p = self.packed
        put = lambda a, dt: torch.as_tensor(a, dtype=dt).to(self.device)
        return (terms, counts, put(p.readers, torch.int32), put(p.ratings, self.dtype),
                doc_mask)

    def _build_trainer(self, cfg: TrainConfig) -> Trainer:
        p = self.packed
        step = ctpf_mod.make_step(p, self.K, viter=cfg.viter, vtol=cfg.vtol,
                                  chunk_docs=self.chunk_docs, device=self.device)
        elbo = ctpf_mod.make_elbo(p, self.K, chunk_docs=self.chunk_docs)
        data = self._step_data()
        return Trainer(step, elbo, data, data, M=self.M, C=int(sum(self.C)),
                       device=self.device)

    def train(self, iter: int = 150, tol: float = 1.0, viter: int = 10,
              vtol: Optional[float] = None, checkelbo: float = 1,
              printelbo: bool = True):
        """train! (CTPF.jl:344-376): no niter/ntol (no Newton steps)."""
        return super().train(iter=iter, tol=tol, viter=viter, vtol=vtol,
                             checkelbo=checkelbo, printelbo=printelbo)

    def _topic_word_matrix(self) -> torch.Tensor:
        # Ebeta = alef ./ bet (CTPF.jl:378)
        return self.state.alef / self.state.bet[:, None]

    def _finalize(self):
        super()._finalize()
        # scores Eeta'·(Etheta+Eepsilon) (CTPF.jl:381-386): one product on
        # the device, kept there; past _SCORES_DENSE_MAX elements rec rows
        # come from per-row products instead
        if self.M * self.U > self._SCORES_DENSE_MAX:
            self._scores_dev = None
            self._lazy_scores = True
        else:
            s = ctpf_mod.scores(self.state)
            rows = torch.as_tensor(self._doc_rows(), device=self.device)
            self._scores_dev = s[rows][:, : self.U]
            self._lazy_scores = False
        self._scores_np = None

    # ── Hebrew-letter parameter accessors ──
    @property
    def alef(self) -> np.ndarray:
        return _host(self.state.alef)

    @property
    def bet(self) -> np.ndarray:
        return _host(self.state.bet)

    @property
    def gimel(self) -> np.ndarray:
        return _host(self.state.gimel)[self._doc_rows()]

    @property
    def dalet(self) -> np.ndarray:
        return _host(self.state.dalet)

    @property
    def he(self) -> np.ndarray:
        return _host(self.state.he)[:, : self.U]

    @property
    def vav(self) -> np.ndarray:
        return _host(self.state.vav)

    @property
    def zayin(self) -> np.ndarray:
        return _host(self.state.zayin)[self._doc_rows()]

    @property
    def het(self) -> np.ndarray:
        return _host(self.state.het)

    def _topicdist_rows(self, rows: np.ndarray) -> np.ndarray:
        g = _host(self.state.gimel)[rows]
        return g / g.sum(axis=-1, keepdims=True)


class CTM(TopicModel):
    """Correlated topic model (reference src/CTM.jl, src/gpuCTM.jl).

    ``identify=True`` opts into the projection normalisation the
    reference's todo.txt:25 proposes for the logistic normal's
    unidentified direction (see ``models/ctm.py:gaussian_update``).
    Default off: the reference's exact semantics."""

    _bucketed = True
    _preferred_chunk = 2048
    _model = ctm_mod

    def __init__(self, corp: PackedCorpus, K: int,
                 runtime: Optional[RuntimeConfig] = None, *, device, seed: int = 0,
                 identify: bool = False):
        self.identify = bool(identify)
        super().__init__(corp, K, runtime, device=device, seed=seed)

    def __repr__(self):
        return f"Correlated topic model with {self.K} topics."

    def _init_state(self):
        gen = torch.Generator().manual_seed(self.seed)
        self.state = self._model.init(gen, self.packed, self.K, self.dtype, self.device)

    def _build_trainer(self, cfg: TrainConfig) -> Trainer:
        p = self.packed
        step = self._model.make_step(
            p, self.K, viter=cfg.viter, vtol=cfg.vtol, niter=cfg.niter, ntol=cfg.ntol,
            chunk_docs=self.chunk_docs, device=self.device, identify=self.identify)
        elbo = self._model.make_elbo(p, self.K, chunk_docs=self.chunk_docs)
        data = self._data_arrays()
        return Trainer(step, elbo, data + (float(self.M),), data, M=self.M,
                       C=int(sum(self.C)), device=self.device)

    @property
    def mu(self) -> np.ndarray:
        return _host(self.state.mu)

    @property
    def sigma(self) -> np.ndarray:
        return _host(self.state.sigma)

    @property
    def invsigma(self) -> np.ndarray:
        return _host(self.state.invsigma)

    @property
    def beta(self) -> np.ndarray:
        return _host(self.state.beta)

    @property
    def lam(self) -> np.ndarray:
        return _host(self.state.lam)[self._doc_rows()]

    lambda_ = lam   # the reference's field name

    @property
    def vsq(self) -> np.ndarray:
        return _host(self.state.vsq)[self._doc_rows()]

    @property
    def logzeta(self) -> np.ndarray:
        return _host(self.state.logzeta)[self._doc_rows()]

    def _topicdist_rows(self, rows: np.ndarray) -> np.ndarray:
        rows = torch.as_tensor(rows, device=self.device)
        return _host(ctm_mod.topicdist(self.state.lam[rows], self.state.vsq[rows]))


class fCTM(CTM):
    """Filtered correlated topic model (reference src/fCTM.jl).

    ``identify=True`` gauge-fixes the Gaussian channel as CTM's does."""

    _model = fctm_mod

    def __repr__(self):
        return f"Filtered correlated topic model with {self.K} topics."

    @property
    def eta(self) -> float:
        return float(self.state.eta)

    @property
    def kappa(self) -> np.ndarray:
        return _host(self.state.kappa)

    @property
    def tau(self):
        """Ragged view: list of per-doc tau vectors (reference fCTM.jl:28)."""
        t = _host(self.state.tau)
        rows = self._doc_rows()
        return [t[rows[d], : self.N[d]] for d in range(self.M)]
