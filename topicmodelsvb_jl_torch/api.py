"""User-facing model API.

Mirrors the reference's public surface (src/TopicModelsVB.jl:11-18):
``Model(corp, K)`` constructors on a :class:`~.corpus.Corpus` or a
:class:`~.ops.packing.PackedCorpus`, ``train(...)`` with the reference's
kwargs and defaults, and the post-hoc tools ``topicdist``,
``showtopics``, ``predict``, ``gendoc``/``gencorp`` and, for CTPF,
``showlibs``/``showdrecs``/``showurecs`` and ``warm_start_from``, the
dynamic topic model ``DTM`` and the hidden Markov topic model ``HMTM``.
A model runs on the CUDA device unless its caller names another
(``device="cpu"``); without a CUDA device it raises rather than fall
back.  ``RuntimeConfig.checkpoint_every`` and
``checkpoint_dir`` checkpoint a run as it trains (``checkpoint.py``);
``profile_dir`` captures steps with ``torch.profiler``, and each model's
``_flops_per_step`` (the JAX package's arithmetic) over the step time and
``peak_flops`` gives the summary's MFU figure.
"""

from __future__ import annotations

import dataclasses
import math
import os
import shutil
from typing import Optional

import numpy as np
import torch

from . import corpus as corpuslib
from .corpus import Corpus, CorpusError, Document
from .engine import Trainer, device_peak_flops
from .kernels._build import check_dtype
from .models import ctm as ctm_mod
from .models import ctpf as ctpf_mod
from .models import dtm as dtm_mod
from .models import fctm as fctm_mod
from .models import flda as flda_mod
from .models import hmtm as hmtm_mod
from .models import lda as lda_mod
from .ops.packing import PackedCorpus, _round_up, bucketize_packed, pack_corpus
from .parallel import multihost, shard
from .parallel.mesh import (
    axis_index, axis_size, check_axes, data_shape, is_local, make_mesh,
)
from .utils.config import RuntimeConfig, TrainConfig
from .utils.display import bullet, juliadots
from .utils.numerics import elbo_value


class TopicModelError(Exception):
    """Mirror of the reference TopicModelError (modelutils.jl:1-5)."""


class TopicModel:
    """Construction and packing shared by the models."""

    _family = ""        # the model family, for the dtype gate (kernels._build.check_dtype)
    _uses_readers = False
    _bucketed = False   # length-bucketed token packing
    _per_doc_fields: tuple = ()   # state fields with a leading doc axis
    # chunk_docs when the caller passes no RuntimeConfig, as in the JAX
    # package (api.py:52-55): the Newton-heavy CTM and fCTM take 2048
    _preferred_chunk = 1024

    def __init__(self, corp, K: int, runtime: Optional[RuntimeConfig] = None, *,
                 mesh=None, device="cuda", seed: int = 0):
        """``corp`` is a :class:`~.corpus.Corpus`, or a :class:`PackedCorpus`
        (dense, or bucketed for the mesh's data-axis size) for data that
        never existed as Document objects; a model built from a
        PackedCorpus has no corpus-text displays.  ``device`` is where the
        state and the data live: the CUDA device unless the caller names
        another.

        ``mesh`` shards the documents over its data axis
        (``runtime.data_axis``), one process a shard (``parallel/``): every
        process builds the model from the same corpus and keeps only its
        own slab of the packed rows and of the per-document state.  The
        mesh's other axes, if any, replicate the slabs, as in the JAX
        package, whose api models shard over the data axis alone.  With
        no mesh, it is every process of an initialised process group
        (``parallel.multihost.initialize``), or else this one device."""
        if K <= 0:
            raise ValueError("number of topics must be a positive integer.")
        if not isinstance(corp, (Corpus, PackedCorpus)):
            raise TypeError(f"the model takes a Corpus or a PackedCorpus (got {type(corp)})")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {str(self.device)!r}: no CUDA device is available; "
                               "pass device='cpu' to run on the CPU")

        self.K = int(K)
        self.runtime = (runtime if runtime is not None
                        else RuntimeConfig(chunk_docs=self._preferred_chunk))
        self.dtype = getattr(torch, self.runtime.dtype)
        # the state's dtype on this device, before anything is allocated:
        # the api models shard over the data axis alone, which adds no kernel
        check_dtype(self._family, self.dtype, self.device)
        # the MFU figure's peak: the runtime's, else this device's own in
        # the state's dtype
        self.peak_flops = (float(self.runtime.peak_flops) if self.runtime.peak_flops is not None
                           else device_peak_flops(self.device, self.dtype))
        self.seed = seed
        ax = self.runtime.data_axis
        shape = data_shape(self.runtime.mesh_shape)
        if mesh is None and (multihost.is_initialized() or shape is not None):
            mesh = make_mesh(axis_names=(ax,), shape=shape)
        if mesh is not None:
            check_axes(mesh, ax)
        self.mesh = mesh
        # the mesh the steps reduce over: None when there is nothing to reduce
        self._red_mesh = None if is_local(mesh) else mesh
        n_sh = axis_size(mesh, ax)
        self._n_shards, self._shard = n_sh, axis_index(mesh, ax)
        # a mesh's other axes replicate the documents, as the JAX package's
        # api does (its steps shard over the data axis alone): this
        # process's index among the replicas of its slab
        others = tuple(a for a in getattr(mesh, "mesh_dim_names", ()) if a != ax)
        self._replica = axis_index(mesh, others)
        self.corp = None
        # what the checkpoint fingerprint hashes, lazily (_fingerprint): the
        # corpus, or the packed object the caller holds, before bucketing
        self._fp_src = corp
        per_shard = max(1, math.ceil(max(len(corp.docs) if isinstance(corp, Corpus)
                                         else corp.M, 1) / n_sh))
        if isinstance(corp, Corpus):
            corpuslib.check_corp(corp)
            self.corp = corp.copy()   # corpus-level isolation (LDA.jl:44)
            self._fp_src = self.corp
            corp = pack_corpus(self.corp, pad_multiple=self.runtime.pad_multiple,
                               docs_multiple=min(self.runtime.chunk_docs,
                                                 _round_up(per_shard, 8)) * n_sh,
                               with_readers=self._uses_readers,
                               dtype=np.dtype(self.runtime.dtype))
        # a Corpus's users count even where the model packs no readers
        self.M, self.V, self.U = (corp.M, corp.V, corp.U) if self.corp is None else self.corp.shape
        if corp.inv_order is not None:
            # already bucketized: rows are length-permuted and
            # interleaved with padding — index back to doc order
            rows = corp.inv_order[: corp.M]
            self.N = corp.N[rows].tolist()
            self.C = corp.C[rows].tolist()
        else:
            self.N = corp.N[: corp.M].tolist()
            self.C = corp.C[: corp.M].tolist()
        if corp.segments is not None and corp.n_shards != n_sh:
            # bucketed rows are shard-major for corp.n_shards shards: another
            # data-axis size would pair each shard's segment rows with the
            # wrong per-document state rows
            raise TopicModelError(
                f"pre-bucketed corpus was laid out for n_shards="
                f"{corp.n_shards} but the mesh data axis has {n_sh} "
                f"shards; re-bucketize with n_shards={n_sh}.")
        cand = min(self.runtime.chunk_docs, _round_up(per_shard, 8))
        if corp.segments is not None and corp.chunk:
            # pre-bucketed rows come in multiples of corp.chunk per shard:
            # clamp to a divisor so the chunks tile evenly
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
                self.packed, chunk=self.chunk_docs, n_shards=n_sh,
                pad_multiple=min(self.runtime.bucket_pad,
                                 self.runtime.pad_multiple))
        elif not self._bucketed and self.packed.M_pad % (self.chunk_docs * n_sh):
            raise ValueError(f"packed doc axis {self.packed.M_pad} must divide into "
                             f"chunk_docs×shards = {self.chunk_docs}×{n_sh}")
        for s in self.packed.segments or ():
            # the kernels index the [V, K] table with these ids unchecked
            if s.terms.size and (s.terms.min() < 0 or s.terms.max() >= self.V):
                raise ValueError(f"term ids must lie in [0, {self.V})")
        r = self.packed.readers
        if self._uses_readers and r.size and (r.min() < 0 or r.max() >= max(self.U, 1)):
            raise ValueError(f"reader ids must lie in [0, {max(self.U, 1)})")
        # this process's slab of the packed rows (the whole corpus on one
        # shard); the state holds its rows, global rows [_row_lo, _row_lo + M_pad)
        self.local_packed = multihost.local_packed(self.packed, n_sh, self._shard)
        self._row_lo = self._shard * self.local_packed.M_pad
        self.state = None
        self.trainer: Optional[Trainer] = None
        self.topics: Optional[np.ndarray] = None  # [K, V] 1-based rankings
        # the global outer-iteration counter, carried by checkpoints
        self.trained_iters: int = 0
        self._ckpt_writer = None   # checkpoint.AsyncWriter when auto-checkpointing
        self._init_state()

    @property
    def _fingerprint(self) -> str:
        """The corpus fingerprint of a checkpoint, hashed at the first
        checkpoint (seconds at NSF scale) and kept: the corpus does not
        change during the model's life."""
        if getattr(self, "_fingerprint_cache", None) is None:
            from .checkpoint import corpus_fingerprint, packed_fingerprint

            src = self._fp_src
            self._fingerprint_cache = (corpus_fingerprint(src) if isinstance(src, Corpus)
                                       else packed_fingerprint(src))
            self._fp_src = None
        return self._fingerprint_cache

    def _ctor_kwargs(self) -> dict:
        """Extra constructor arguments a checkpoint must replay."""
        return {}

    def _dp(self) -> dict:
        """The mesh and axis a step and a bound reduce over."""
        return dict(mesh=self._red_mesh, axis_name=self.runtime.data_axis)

    def _local_rows(self, a):
        """This process's rows of a whole per-row array (packed-row order)."""
        return multihost.local_rows(a, self._n_shards, self._shard)

    def _require_whole(self) -> None:
        """Raise on a model sharded over processes: each holds its own rows
        of the per-document state, never to be passed off as the whole."""
        if self._n_shards > 1:
            raise TopicModelError(
                f"the per-document state is sharded over {self._n_shards} processes, "
                "each holding its own rows; save a checkpoint (save_checkpoint) and "
                "load it in one process to read it.")

    def _whole(self, t: torch.Tensor) -> np.ndarray:
        """A per-document state field on the host, every packed row of it."""
        self._require_whole()
        return _host(t)

    def _padded_tokens(self) -> int:
        """Token slots a sweep processes, padding included."""
        p = self.packed
        if p.segments is not None:
            return int(sum(s.terms.size for s in p.segments))
        return int(np.asarray(p.terms).size)

    def _viter(self) -> int:
        """The running train's viter (10 before any train)."""
        return self._cfg.viter if getattr(self, "_cfg", None) else 10

    def _flops_per_step(self) -> float:
        """Arithmetic of one outer iteration for the MFU figure, the JAX
        package's estimate (its api.py:241): ~6 flops per (token slot,
        topic) in each of ``viter`` passes (the phi product and
        normalisation, the gamma and beta statistics, LDA.jl:129-154).
        The families add their deterministic extra work; iterations that
        stop early are counted in full and data-dependent ones not at
        all, so the figure is an estimate of the whole corpus's work."""
        return float(self._viter() * self._padded_tokens() * 6 * self.K)

    def _trainer_kw(self) -> dict:
        """The Trainer's sinks: the JSONL metrics file and, with
        ``checkpoint_every`` and ``checkpoint_dir`` set, the checkpoint
        callback.  On one process each checkpoint is taken on the training
        thread (its device-to-host copy started, not waited for) and
        written by a background thread to a ``.tmp`` file, then renamed
        over ``ckpt_iter{k:06d}``, so a kill mid-write never leaves a torn
        checkpoint; one write is in flight at a time.  A model sharded over
        processes writes the directory format synchronously (every
        process its own rows, ``checkpoint.save``); process 0 renames it.
        Only the first process prints, writes metrics and profiles.  With
        them, the step's flops and the peak of the MFU figure."""
        rt = self.runtime
        lead = self._shard == 0 and self._replica == 0
        kw = dict(metrics_path=rt.metrics_path, main=lead,
                  flops_per_step=self._flops_per_step(), peak_flops=self.peak_flops,
                  profile_dir=rt.profile_dir, profile_steps=rt.profile_steps)
        if rt.checkpoint_every > 0 and rt.checkpoint_dir:
            from . import checkpoint as ckptlib

            def clear(p):
                # a killed run's leftover: a file, or the directory of a
                # multi-process run
                if os.path.isdir(p):
                    shutil.rmtree(p)
                elif os.path.exists(p):
                    os.remove(p)

            def ckpt_cb(k, state):
                self.state = state
                self.trained_iters = int(k)   # the checkpoint carries global k
                os.makedirs(rt.checkpoint_dir, exist_ok=True)
                final = os.path.join(rt.checkpoint_dir, f"ckpt_iter{k:06d}")
                tmp = final + ".tmp"
                if self._n_shards > 1:
                    # no process writes into a stale tmp that process 0 is
                    # still removing
                    if lead:
                        clear(tmp)
                    shard.barrier(self.mesh)
                    ckptlib.save(tmp, self,
                                 compress="f16" if rt.checkpoint_f16 else None)
                    if lead:
                        # a directory cannot be renamed over a non-empty one
                        clear(final)
                        os.replace(tmp, final)
                    return
                if self._ckpt_writer is None:
                    self._ckpt_writer = ckptlib.AsyncWriter()
                snap = ckptlib.snapshot(self, compress="f16" if rt.checkpoint_f16 else None)

                def write():
                    clear(tmp)
                    ckptlib.write_snapshot(tmp, snap)
                    # os.replace cannot replace a directory; a file it
                    # replaces atomically, so a final file is never removed
                    if os.path.isdir(final):
                        clear(final)
                    os.replace(tmp, final)

                self._ckpt_writer.submit(write)

            kw.update(checkpoint_cb=ckpt_cb, checkpoint_every=rt.checkpoint_every)
        return kw

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
        """This process's per-segment (terms, counts, doc_mask) tensors on
        the device."""
        segs = self.local_packed.segments
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
        n_rows = self.local_packed.M_pad
        for f in self._per_doc_fields:
            if getattr(self.state, f).shape[0] != n_rows:
                raise TopicModelError(
                    f"state field {f} has {getattr(self.state, f).shape[0]} rows; this "
                    f"process holds {n_rows} (convert.state_for gives a process its rows)")
        check_model(self)
        self._cfg = cfg
        self.trainer = self._build_trainer(cfg)
        all_empty = all(n == 0 for n in self.N)
        try:
            self.state = self.trainer.train(
                self.state, cfg, corpus_all_empty=all_empty,
                start_iter=self.trained_iters)
        except BaseException:
            # drain the writer, but keep the training error primary: a
            # deferred write error must not mask it
            if self._ckpt_writer is not None:
                try:
                    self._ckpt_writer.wait()
                except Exception:
                    pass
            raise
        if self._ckpt_writer is not None:
            self._ckpt_writer.wait()   # a deferred write error surfaces here
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
        self._require_whole()
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

    def infer(self, corp, iter: int = 10, tol: Optional[float] = None,
              niter: int = 1000, ntol: Optional[float] = None):
        """E-step-only inference on new documents with frozen globals, the
        serve path (reference predict, modelutils.jl:831-855): the same
        as :func:`predict`.  Nothing is cached between calls: a step's
        scatter plans are built from its corpus's term ids."""
        return predict(corp, self, iter=iter, tol=tol, niter=niter, ntol=ntol)

    def showtopics(self, V: int = 15, topics=None, cols: int = 4):
        """Aligned top-terms display (reference modelutils.jl:656-684)."""
        if V <= 0:
            raise ValueError("number of displayed terms must be a positive integer.")
        if cols <= 0:
            raise ValueError("cols must be a positive integer.")
        if topics is None:
            topics = range(1, self.K + 1)
        if isinstance(topics, int):
            topics = [topics]
        topics = list(topics)
        if not all(1 <= t <= self.K for t in topics):
            raise ValueError("some topic indices are outside range.")
        V = min(V, self.V)
        cols = min(cols, len(topics))
        vocab = self.corp.vocab if self.corp is not None else {}
        rank = self.topics if self.topics is not None else lda_mod.topics_ranking(
            self._topic_word_matrix())

        blocks = [topics[i : i + cols] for i in range(0, len(topics), cols)]
        for n, block in enumerate(blocks):
            col_words = [[vocab.get(int(rank[t - 1, j]), f"#term{int(rank[t - 1, j])}")
                          for j in range(V)] for t in block]
            widths = [max(len(f"topic {t}"), max(len(w) for w in words)) + 3
                      for t, words in zip(block, col_words)]
            line = "".join(f"topic {t}".ljust(w) for t, w in zip(block, widths))
            print(line.rstrip())
            for j in range(V):
                print("".join(words[j].ljust(w) for words, w in zip(col_words, widths)).rstrip())
            if n < len(blocks) - 1:
                print()

    def _require_corp(self):
        if self.corp is None:
            raise TopicModelError("this model was built from a PackedCorpus; corpus-text "
                                  "displays need a Corpus.")

    def showdocs(self, docs=None):
        self._require_corp()
        corpuslib.showdocs(self.corp, docs)

    def showtitles(self, docs=None):
        self._require_corp()
        corpuslib.showtitles(self.corp, docs)

    def getvocab(self):
        self._require_corp()
        return corpuslib.getvocab(self.corp)

    def getusers(self):
        self._require_corp()
        return corpuslib.getusers(self.corp)


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
        return self._whole(self.state.gamma)[self._doc_rows()]

    @property
    def Elogtheta(self) -> np.ndarray:
        return self._whole(self.state.Elogtheta)[self._doc_rows()]

    def _topicdist_rows(self, rows: np.ndarray) -> np.ndarray:
        return _host(lda_mod.topicdist(self.state, torch.as_tensor(rows)))


class LDA(_DirichletAccessors, TopicModel):
    """Latent Dirichlet allocation (reference src/LDA.jl, src/gpuLDA.jl)."""

    _family = "LDA"
    _bucketed = True
    _per_doc_fields = ("gamma", "Elogtheta", "Elogtheta_old")

    def __repr__(self):
        return f"Latent Dirichlet allocation model with {self.K} topics."

    def _init_state(self):
        gen = torch.Generator().manual_seed(self.seed)
        self.state = lda_mod.init(gen, self.local_packed, self.K, self.dtype,
                                  self.device)

    def _build_trainer(self, cfg: TrainConfig) -> Trainer:
        p = self.local_packed
        step = lda_mod.make_step(
            p, self.K, viter=cfg.viter, vtol=cfg.vtol, niter=cfg.niter,
            ntol=cfg.ntol, chunk_docs=self.chunk_docs, device=self.device,
            elogtheta_f64=self.runtime.elogtheta_f64, **self._dp())
        elbo = lda_mod.make_elbo(p, self.K, chunk_docs=self.chunk_docs, **self._dp())
        data = self._data_arrays()
        return Trainer(step, elbo, data + (float(self.M),), data,
                       M=self.M, C=int(sum(self.C)), device=self.device,
                       **self._trainer_kw())


class fLDA(_DirichletAccessors, TopicModel):
    """Filtered LDA (reference src/fLDA.jl)."""

    _family = "fLDA"
    _bucketed = True
    _per_doc_fields = ("gamma", "Elogtheta", "Elogtheta_old", "tau", "tau_old")

    def __repr__(self):
        return f"Filtered latent Dirichlet allocation model with {self.K} topics."

    def _flops_per_step(self) -> float:
        """The base estimate + ~4 flops a token slot a pass for tau
        (fLDA.jl:195-200; JAX api.py:863)."""
        return super()._flops_per_step() + float(self._viter() * self._padded_tokens() * 4)

    def _init_state(self):
        gen = torch.Generator().manual_seed(self.seed)
        self.state = flda_mod.init(gen, self.local_packed, self.K, self.dtype,
                                   self.device)

    def _build_trainer(self, cfg: TrainConfig) -> Trainer:
        p = self.local_packed
        step = flda_mod.make_step(
            p, self.K, viter=cfg.viter, vtol=cfg.vtol, niter=cfg.niter,
            ntol=cfg.ntol, chunk_docs=self.chunk_docs, device=self.device,
            elogtheta_f64=self.runtime.elogtheta_f64, **self._dp())
        elbo = flda_mod.make_elbo(p, self.K, chunk_docs=self.chunk_docs, **self._dp())
        data = self._data_arrays()
        C = sum(self.C)
        # M_total and C_total stay on the device, like eta
        totals = tuple(torch.tensor(float(x), dtype=self.dtype, device=self.device)
                       for x in (self.M, C))
        return Trainer(step, elbo, data + totals, data, M=self.M, C=int(C),
                       device=self.device, **self._trainer_kw())

    @property
    def eta(self) -> float:
        return float(self.state.eta)

    @property
    def kappa(self) -> np.ndarray:
        return _host(self.state.kappa)

    @property
    def tau(self):
        """Ragged view: list of per-doc tau vectors (reference fLDA.jl:25)."""
        t = self._whole(self.state.tau)
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

    _family = "CTPF"
    _uses_readers = True
    _bucketed = True
    _per_doc_fields = ("gimel", "gimel_old", "zayin", "zayin_old")
    # past this many M·U elements the dense score matrix is never built
    # (not even on the device): ranked rec rows come from O((M+U)·K)
    # matrix-vector products against the factor state instead
    _SCORES_DENSE_MAX = 100_000_000

    def __init__(self, corp, K: int, runtime: Optional[RuntimeConfig] = None, *,
                 mesh=None, device="cuda", seed: int = 0):
        super().__init__(corp, K, runtime, mesh=mesh, device=device, seed=seed)
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
        self._urecs = None
        self._drecs = None
        self._ranked = False

    def _flops_per_step(self) -> float:
        """The base estimate + the 2K-wide reader responsibilities, ~6 flops
        a rating slot and lane a pass (CTPF.jl:334-337; JAX api.py:980)."""
        r = self.packed.readers
        r_slots = 0 if r is None else int(np.asarray(r).size)
        return super()._flops_per_step() + float(self._viter() * r_slots * 12 * self.K)

    def __repr__(self):
        return f"Collaborative topic Poisson factorization model with {self.K} topics."

    @property
    def scores(self) -> np.ndarray:
        self._require_whole()
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

    @scores.setter
    def scores(self, v):
        self._scores_np = np.asarray(v)
        self._scores_dev = None
        self._lazy_scores = False
        # scores assigned by the user define the ranking
        self._ranked = bool(np.any(self._scores_np))
        self._urecs = None
        self._drecs = None

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
        self._require_whole()
        if kind == "d":   # users for document i
            n = self.U
            p = self.packed
            row = int(self._rows(i))
            excl = p.readers[row, : p.R[row]].astype(np.int64) + 1
        else:             # documents for user i
            n = self.M
            excl = np.asarray(self.libs[i], dtype=np.int64)
        if self._ranked and n:
            order = np.argsort(-self._score_slice(kind, i), kind="stable")
        else:
            order = np.arange(n, dtype=np.int64)
        mask = np.ones(n, dtype=bool)
        if excl.size:
            mask[excl - 1] = False
        return (order[mask[order]] + 1).tolist()

    @property
    def urecs(self):
        if self._urecs is None:
            self._urecs = _LazyRecs(self, "u", self.U)
        return self._urecs

    @urecs.setter
    def urecs(self, v):
        self._urecs = v

    @property
    def drecs(self):
        if self._drecs is None:
            self._drecs = _LazyRecs(self, "d", self.M)
        return self._drecs

    @drecs.setter
    def drecs(self, v):
        self._drecs = v

    def _init_state(self):
        gen = torch.Generator().manual_seed(self.seed)
        self.state = ctpf_mod.init(gen, self.local_packed, self.K, self.dtype,
                                   self.device)

    def _step_data(self) -> tuple:
        """(terms, counts, readers, ratings, doc_mask): per-segment token
        tuples and the dense reader arrays, on the device."""
        terms, counts, doc_mask = self._data_arrays()
        p = self.local_packed
        put = lambda a, dt: torch.as_tensor(a, dtype=dt).to(self.device)
        return (terms, counts, put(p.readers, torch.int32), put(p.ratings, self.dtype),
                doc_mask)

    def _build_trainer(self, cfg: TrainConfig) -> Trainer:
        p = self.local_packed
        step = ctpf_mod.make_step(p, self.K, viter=cfg.viter, vtol=cfg.vtol,
                                  chunk_docs=self.chunk_docs, device=self.device, **self._dp())
        elbo = ctpf_mod.make_elbo(p, self.K, chunk_docs=self.chunk_docs, **self._dp())
        data = self._step_data()
        return Trainer(step, elbo, data, data, M=self.M, C=int(sum(self.C)),
                       device=self.device, **self._trainer_kw())

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
        if self._n_shards > 1:   # the scores need every document's state
            self._scores_dev = None
            self._lazy_scores = False
        elif self.M * self.U > self._SCORES_DENSE_MAX:
            self._scores_dev = None
            self._lazy_scores = True
        else:
            s = ctpf_mod.scores(self.state)
            rows = torch.as_tensor(self._doc_rows(), device=self.device)
            self._scores_dev = s[rows][:, : self.U]
            self._lazy_scores = False
        self._scores_np = None
        self._ranked = self._n_shards == 1
        self._urecs = None
        self._drecs = None

    # ── Hebrew-letter parameter accessors ──
    @property
    def alef(self) -> np.ndarray:
        return _host(self.state.alef)

    @property
    def bet(self) -> np.ndarray:
        return _host(self.state.bet)

    @property
    def gimel(self) -> np.ndarray:
        return self._whole(self.state.gimel)[self._doc_rows()]

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
        return self._whole(self.state.zayin)[self._doc_rows()]

    @property
    def het(self) -> np.ndarray:
        return _host(self.state.het)

    def _topicdist_rows(self, rows: np.ndarray) -> np.ndarray:
        g = _host(self.state.gimel)[rows]
        return g / g.sum(axis=-1, keepdims=True)

    def warm_start_from(self, model: TopicModel) -> "CTPF":
        """Seed alef from a trained LDA/CTM-family beta:
        ``ctpf.alef = exp(beta)`` (reference README.md:669-674).  The step
        builds its exp(ψ) tables from alef anew every iteration, so
        nothing else needs to change."""
        beta = np.asarray(model.beta)
        if beta.shape != (self.K, self.V):
            raise ValueError("warm-start model must share K and V.")
        alef = torch.as_tensor(np.exp(beta), dtype=self.dtype).to(self.device)
        self.state = dataclasses.replace(self.state, alef=alef, alef_old=alef)
        return self

    # ── recommender displays (modelutils.jl:691-824) ──
    def showlibs(self, users=None):
        self._require_corp()
        if users is None:
            users = range(1, self.U + 1)
        if isinstance(users, int):
            users = [users]
        users = list(users)
        if not all(1 <= u <= self.U for u in users):
            raise ValueError("some user indices are outside range.")
        for n, u in enumerate(users):
            if not self.libs[u - 1]:
                continue
            juliadots(f"User {u}\n")
            name = self.corp.users.get(u, "")
            if name and not name.startswith("#user"):
                juliadots(f"{name}\n")
            for d in self.libs[u - 1]:
                bullet(self.corp.docs[d - 1].title or f"Document {d}")
            if n < len(users) - 1:
                print()

    def showdrecs(self, docs=None, U: int = 15):
        """Top U user recommendations per document (modelutils.jl:729-770)."""
        self._require_corp()
        if U <= 0:
            raise ValueError("number of displayed users must be a positive integer.")
        if docs is None:
            docs = range(1, self.M + 1)
        if isinstance(docs, int):
            docs = [docs]
        docs = list(docs)
        if not all(1 <= d <= self.M for d in docs):
            raise ValueError("some document indices are outside range.")
        U = min(U, self.U)
        for n, d in enumerate(docs):
            row = self.drecs[d - 1]
            if not row:
                continue
            juliadots(f"Document {d}\n")
            if self.corp.docs[d - 1].title:
                juliadots(f"{self.corp.docs[d - 1].title}\n")
            for rank, u in enumerate(row[:U], start=1):
                print(f"{rank}. {self.corp.users.get(u, f'#user{u}')}")
            if n < len(docs) - 1:
                print()

    def showurecs(self, users=None, M: int = 15):
        """Top M document recommendations per user (modelutils.jl:777-821)."""
        self._require_corp()
        if M <= 0:
            raise ValueError("number of displayed documents must be a positive integer.")
        if users is None:
            users = range(1, self.U + 1)
        if isinstance(users, int):
            users = [users]
        users = list(users)
        if not all(1 <= u <= self.U for u in users):
            raise ValueError("some user indices are outside range.")
        M = min(M, self.M)
        for n, u in enumerate(users):
            row = self.urecs[u - 1]
            if not row:
                continue
            juliadots(f"User {u}\n")
            name = self.corp.users.get(u, "")
            if name and not name.startswith("#user"):
                juliadots(f"{name}\n")
            for rank, d in enumerate(row[:M], start=1):
                print(f"{rank}. {self.corp.docs[d - 1].title or f'Document {d}'}")
            if n < len(users) - 1:
                print()


class CTM(TopicModel):
    """Correlated topic model (reference src/CTM.jl, src/gpuCTM.jl).

    ``identify=True`` opts into the projection normalisation the
    reference's todo.txt:25 proposes for the logistic normal's
    unidentified direction (see ``models/ctm.py:gaussian_update``).
    Default off: the reference's exact semantics."""

    _family = "CTM"
    _bucketed = True
    _preferred_chunk = 2048
    _per_doc_fields = ("lam", "lam_old", "vsq", "logzeta")
    _model = ctm_mod

    def __init__(self, corp, K: int, runtime: Optional[RuntimeConfig] = None, *,
                 mesh=None, device="cuda", seed: int = 0, identify: bool = False):
        self.identify = bool(identify)
        super().__init__(corp, K, runtime, mesh=mesh, device=device, seed=seed)

    def __repr__(self):
        return f"Correlated topic model with {self.K} topics."

    def _flops_per_step(self) -> float:
        """The base estimate + the lambda Newton's floor a pass: one PCG
        matvec (2K²) and ~10K of elementwise work a document (JAX
        api.py:674)."""
        return TopicModel._flops_per_step(self) + float(
            self._viter() * self.packed.M_pad * (2 * self.K**2 + 10 * self.K))

    def _ctor_kwargs(self) -> dict:
        # rides the checkpoint so a resumed run keeps the same gauge
        return {"identify": True} if self.identify else {}

    def _init_state(self):
        gen = torch.Generator().manual_seed(self.seed)
        self.state = self._model.init(gen, self.local_packed, self.K, self.dtype, self.device)

    def _build_trainer(self, cfg: TrainConfig) -> Trainer:
        p = self.local_packed
        step = self._model.make_step(
            p, self.K, viter=cfg.viter, vtol=cfg.vtol, niter=cfg.niter, ntol=cfg.ntol,
            chunk_docs=self.chunk_docs, device=self.device, identify=self.identify, **self._dp())
        elbo = self._model.make_elbo(p, self.K, chunk_docs=self.chunk_docs, **self._dp())
        data = self._data_arrays()
        return Trainer(step, elbo, data + (float(self.M),), data, M=self.M,
                       C=int(sum(self.C)), device=self.device, **self._trainer_kw())

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
        return self._whole(self.state.lam)[self._doc_rows()]

    lambda_ = lam   # the reference's field name

    @property
    def vsq(self) -> np.ndarray:
        return self._whole(self.state.vsq)[self._doc_rows()]

    @property
    def logzeta(self) -> np.ndarray:
        return self._whole(self.state.logzeta)[self._doc_rows()]

    def _topicdist_rows(self, rows: np.ndarray) -> np.ndarray:
        rows = torch.as_tensor(rows, device=self.device)
        return _host(ctm_mod.topicdist(self.state.lam[rows], self.state.vsq[rows]))


class fCTM(CTM):
    """Filtered correlated topic model (reference src/fCTM.jl).

    ``identify=True`` gauge-fixes the Gaussian channel as CTM's does."""

    _family = "fCTM"
    _per_doc_fields = ("lam", "lam_old", "vsq", "logzeta", "tau", "tau_old")
    _model = fctm_mod

    def __repr__(self):
        return f"Filtered correlated topic model with {self.K} topics."

    def _flops_per_step(self) -> float:
        """CTM's Newton floor + fLDA's ~4 flops a token slot a pass for tau
        (JAX api.py:774)."""
        return TopicModel._flops_per_step(self) + float(
            self._viter() * (self.packed.M_pad * (2 * self.K**2 + 10 * self.K)
                             + self._padded_tokens() * 4))

    @property
    def eta(self) -> float:
        return float(self.state.eta)

    @property
    def kappa(self) -> np.ndarray:
        return _host(self.state.kappa)

    @property
    def tau(self):
        """Ragged view: list of per-doc tau vectors (reference fCTM.jl:28)."""
        t = self._whole(self.state.tau)
        rows = self._doc_rows()
        return [t[rows[d], : self.N[d]] for d in range(self.M)]


class DTM(TopicModel):
    """Dynamic topic model (reference v0.6/src/DTM.jl).

    Cuts the corpus into T slices of width ``delta`` by document stamp
    (``Document.stamp``); the topic-word distributions evolve over the
    slices through a variational Kalman smoother.  Warm-starts from a
    trained LDA, fLDA, CTM or fCTM ``basemodel`` (DTM.jl:66-93).  The
    corpus is packed dense, not bucketed."""

    _family = "DTM"
    _per_doc_fields = ("gamma", "Elogtheta", "lzeta")

    def __init__(self, corp, K: int, delta: float, basemodel=None,
                 runtime: Optional[RuntimeConfig] = None, *, mesh=None, device="cuda",
                 seed: int = 0):
        if not isinstance(corp, Corpus):
            raise TopicModelError("DTM requires a Corpus with per-document stamps; "
                                  "PackedCorpus input is not supported.")
        if not (np.isfinite(delta) and delta > 0):
            raise ValueError("delta must be a positive finite number.")
        if any(d.stamp is None or not np.isfinite(d.stamp) for d in corp.docs):
            raise CorpusError("every document must carry a finite stamp.")
        self.delta = float(delta)
        self._basemodel = basemodel
        super().__init__(corp, K, runtime, mesh=mesh, device=device, seed=seed)

    def __repr__(self):
        return f"Dynamic topic model with {self.K} topics and {self.T} time slices."

    def _flops_per_step(self) -> float:
        """The base estimate + the [T, K, V] Kalman smoother (~20 flops an
        element) and the betahat CG (~10 an element a CG iteration), both
        fixed a step (DTM.jl:209-305; JAX api.py:1445)."""
        cg = getattr(self, "_cgiter", 20)
        return super()._flops_per_step() + float((20 + 10 * cg) * self.T * self.K * self.V)

    def _ctor_kwargs(self) -> dict:
        return {"delta": self.delta}

    def _init_state(self):
        from .streaming import slices_from_stamps

        stamps = np.array([doc.stamp for doc in self.corp.docs], dtype=np.float64)
        # slice assignment (DTM.jl:58-63), 0-based; padding rows in slice 0
        self.T, self.slice_id = slices_from_stamps(stamps, self.delta, self.packed.M_pad)
        self.S = [list(np.nonzero(self.slice_id[: self.M] == t)[0] + 1) for t in range(self.T)]

        bh0 = a0 = g0 = None
        base = self._basemodel
        if base is not None:   # warm start (DTM.jl:66-93), the JAX package's draws
            if base.K != self.K or base.M != self.M:
                raise TopicModelError(
                    "basemodel must have matching number of topics and documents.")
            rng = np.random.default_rng(self.seed)
            M_pad = self.packed.M_pad
            if isinstance(base, (LDA, fLDA)):
                logb = np.log(np.asarray(base.beta) + 1e-30)
                a0 = np.tile(np.asarray(base.alpha), (self.T, 1))
                g0 = np.zeros((M_pad, self.K), np.float64)
                g0[: self.M] = np.asarray(base.gamma)
                g0[self.M:] = 1.0
            elif isinstance(base, CTM):   # fCTM included
                logb = np.log(np.asarray(base.beta) + 1e-30)
                sm = np.exp(np.asarray(base.mu) - np.max(np.asarray(base.mu)))
                a0 = np.tile(sm / sm.sum(), (self.T, 1))
                lam = np.asarray(base.lam)
                e = np.exp(lam - lam.max(axis=1, keepdims=True))
                g0 = np.ones((M_pad, self.K), np.float64)
                g0[: self.M] = e / e.sum(axis=1, keepdims=True)
            else:
                raise TopicModelError("basemodel must be an LDA, fLDA, CTM or fCTM model.")
            bh0 = logb[None, :, :] + rng.standard_normal((self.T, self.K, self.V))
        gen = torch.Generator().manual_seed(self.seed)
        self.state = dtm_mod.init(gen, self.local_packed, self.K, self.T, self.dtype, self.device,
                                  betahat0=bh0, alpha0=a0,
                                  gamma0=None if g0 is None else self._local_rows(g0))

    def _step_data(self) -> tuple:
        """(slice_id, terms, counts, doc_mask): the dense packed arrays on
        the device."""
        p = self.local_packed
        put = lambda a, dt: torch.as_tensor(a, dtype=dt).to(self.device)
        return (put(self._local_rows(self.slice_id), torch.int64), put(p.terms, torch.int32),
                put(p.counts, self.dtype), put(p.doc_mask, self.dtype))

    def _build_trainer(self, cfg: TrainConfig) -> Trainer:
        p = self.local_packed
        step = dtm_mod.make_step(p, self.K, self.T, viter=cfg.viter, vtol=cfg.vtol,
                                 niter=cfg.niter, ntol=cfg.ntol, cgiter=self._cgiter,
                                 cgtol=self._cgtol, chunk_docs=self.chunk_docs,
                                 slice_id=self._local_rows(self.slice_id), device=self.device,
                                 **self._dp())
        elbo = dtm_mod.make_elbo(p, self.K, self.T, chunk_docs=self.chunk_docs, **self._dp())
        data = self._step_data()
        return Trainer(step, elbo, data, data, M=self.M, C=int(sum(self.C)),
                       device=self.device, **self._trainer_kw())

    def train(self, iter: int = 150, tol: float = 1.0, niter: int = 1000,
              ntol: Optional[float] = None, viter: int = 10, vtol: Optional[float] = None,
              cgiter: int = 20, cgtol: Optional[float] = None, checkelbo: float = 1,
              printelbo: bool = True):
        """train! (DTM.jl:311-335), with cgiter/cgtol for the betahat CG."""
        if cgiter <= 0:
            raise ValueError("iteration parameters must be positive integers.")
        self._cgiter = int(cgiter)
        self._cgtol = float(cgtol) if cgtol is not None else 1.0 / self.T**2
        return super().train(iter=iter, tol=tol, niter=niter, ntol=ntol, viter=viter,
                             vtol=vtol, checkelbo=checkelbo, printelbo=printelbo)

    def _finalize(self):
        # per-slice topic rankings (DTM.jl:336)
        self.topics = dtm_mod.topics_ranking_by_slice(self.state.mbeta)

    def _topic_word_matrix(self) -> torch.Tensor:
        return self.state.mbeta.mean(dim=0)

    @property
    def alpha(self) -> np.ndarray:
        return _host(self.state.alpha)

    @property
    def mbeta(self) -> np.ndarray:
        return _host(self.state.mbeta)

    @property
    def vbeta(self) -> np.ndarray:
        return _host(self.state.vbeta)

    @property
    def betahat(self) -> np.ndarray:
        return _host(self.state.betahat)

    @property
    def gamma(self) -> np.ndarray:
        return self._whole(self.state.gamma)[: self.M]

    def _topicdist_rows(self, rows: np.ndarray) -> np.ndarray:
        g = _host(self.state.gamma)[rows]
        return g / g.sum(axis=-1, keepdims=True)

    def showtopics(self, V: int = 15, topics=None, cols: int = 4, slices=None):
        """Aligned top terms, slice by slice (the v0.6 display)."""
        if slices is None:
            slices = range(1, self.T + 1)
        if isinstance(slices, int):
            slices = [slices]
        rank_all = (self.topics if self.topics is not None
                    else dtm_mod.topics_ranking_by_slice(self.state.mbeta))
        for t in slices:
            if not 1 <= t <= self.T:
                raise ValueError("some time-slice indices are outside range.")
            print(f"─ time slice {t} ─")
            saved, self.topics = self.topics, rank_all[t - 1]
            try:
                super().showtopics(V=V, topics=topics, cols=cols)
            finally:
                self.topics = saved


class HMTM(TopicModel):
    """Hidden Markov topic model: the completed form of the reference's
    unfinished research stub (HMTM/HMTM.jl, whose ``updatePhi!`` was never
    solved).  Word order matters: every entry of a document's terms vector
    is one token in order and counts are ignored (HMTM.jl:63-67), so the
    corpus must not be condensed (``expand_corp``).  See models/hmtm.py."""

    _family = "HMTM"
    _bucketed = True
    _per_doc_fields = ("tau", "gamma")

    def __repr__(self):
        # reference Base.show (HMTM.jl:42)
        return f"Hidden Markov topic model with {self.K} topics."

    def _flops_per_step(self) -> float:
        """Forward-backward, ~5K² flops a token in each of viter + 1 sweeps:
        the chain's contractions, not the gather (JAX api.py:606)."""
        return float((self._viter() + 1) * self._padded_tokens() * 5 * self.K**2)

    def _init_state(self):
        gen = torch.Generator().manual_seed(self.seed)
        self.state = hmtm_mod.init(gen, self.local_packed, self.K, self.dtype, self.device)

    def _build_trainer(self, cfg: TrainConfig) -> Trainer:
        p = self.local_packed
        step = hmtm_mod.make_step(
            p, self.K, viter=cfg.viter, vtol=cfg.vtol, niter=cfg.niter,
            ntol=cfg.ntol, chunk_docs=self.chunk_docs, device=self.device, **self._dp())
        elbo = hmtm_mod.make_elbo(p, self.K, chunk_docs=self.chunk_docs, **self._dp())
        data = self._data_arrays()
        return Trainer(step, elbo, data + (float(self.M),), data,
                       M=self.M, C=int(sum(self.C)), device=self.device,
                       **self._trainer_kw())

    @property
    def eta(self) -> np.ndarray:
        return _host(self.state.eta)

    @property
    def alpha(self) -> np.ndarray:
        return _host(self.state.alpha)

    @property
    def beta(self) -> np.ndarray:
        return _host(self.state.beta)

    @property
    def tau(self) -> np.ndarray:
        return self._whole(self.state.tau)[self._doc_rows()]

    @property
    def gamma(self) -> np.ndarray:
        return self._whole(self.state.gamma)[self._doc_rows()]

    def _topicdist_rows(self, rows: np.ndarray) -> np.ndarray:
        return _host(hmtm_mod.topicdist(self.state, torch.as_tensor(rows)))

    def transdist(self, d):
        """Expected per-document topic-transition matrix E_q[theta_d]
        (columns sum to 1), 1-based document index like topicdist."""
        scalar = np.isscalar(d)
        idx = np.atleast_1d(np.asarray(d, dtype=np.int64))
        if np.any((idx < 1) | (idx > self.M)):
            raise CorpusError("some document indices outside corpus range.")
        self._require_whole()
        out = hmtm_mod.transdist(self.state, torch.as_tensor(self._rows(idx - 1)))
        return out[0] if scalar else out


# ───────────────────── inference on new documents (predict) ─────────────────────

def predict(corp: Corpus, train_model: TopicModel, iter: int = 10,
            tol: Optional[float] = None, niter: int = 1000,
            ntol: Optional[float] = None) -> TopicModel:
    """E-step-only inference on a new corpus with frozen global parameters
    (reference modelutils.jl:831-944).

    Returns a new model of the trained class, on its device with its
    runtime and seed, whose per-document variational state is fit against
    the trained globals; call ``topicdist`` on it.  The per-document
    fixpoint runs ``iter`` times with ``tol`` as the convergence break, as
    in the reference, with the JAX package's two repairs: fLDA/fCTM use
    the trained kappa/eta (the reference draws a fresh kappa) and no
    undefined ``vtol`` (modelutils.jl:876,937).
    """
    corpuslib.check_corp(corp)
    if train_model.corp is not None:
        if corp.vocab != train_model.corp.vocab:
            raise CorpusError(
                "predict corpus and train_model corpus must have identical vocabularies.")
    elif len(corp.vocab) != train_model.V:   # PackedCorpus-built model
        raise CorpusError("predict corpus vocabulary size must match the trained model's V.")
    if tol is not None and tol < 0:
        raise ValueError("tolerance parameter must be nonnegative.")
    if iter < 0:
        raise ValueError("iteration parameter must be nonnegative.")
    if isinstance(train_model, CTPF):
        raise TopicModelError("predict is not defined for CTPF models (as in the reference).")
    if isinstance(train_model, DTM):
        raise TopicModelError("predict is not defined for DTM models.")

    cls = type(train_model)
    new = cls(corp, train_model.K, runtime=train_model.runtime, mesh=train_model.mesh,
              device=train_model.device,
              seed=train_model.seed)
    ts = train_model.state
    # the frozen globals; fCTM subclasses CTM here, so it is tested first
    if isinstance(train_model, LDA):
        frozen = dict(alpha=ts.alpha, beta=ts.beta, beta_old=ts.beta)
    elif isinstance(train_model, fLDA):
        frozen = dict(eta=ts.eta, alpha=ts.alpha, kappa=ts.kappa, kappa_old=ts.kappa,
                      beta=ts.beta, beta_old=ts.beta)
    elif isinstance(train_model, fCTM):
        frozen = dict(eta=ts.eta, mu=ts.mu, sigma=ts.sigma, invsigma=ts.invsigma,
                      kappa=ts.kappa, kappa_old=ts.kappa, beta=ts.beta, beta_old=ts.beta)
    elif isinstance(train_model, CTM):
        frozen = dict(mu=ts.mu, sigma=ts.sigma, invsigma=ts.invsigma, beta=ts.beta,
                      beta_old=ts.beta)
    elif isinstance(train_model, HMTM):
        frozen = dict(eta=ts.eta, alpha=ts.alpha, beta=ts.beta)
    else:
        raise TopicModelError(f"predict not implemented for {cls.__name__}")
    new.state = dataclasses.replace(new.state, **frozen)

    # one outer step with viter=iter/vtol=tol runs exactly the reference's
    # per-document fixpoint; its M-step output is dropped below
    cfg = TrainConfig(iter=1, viter=iter, vtol=tol, niter=niter, ntol=ntol,
                      checkelbo=float("inf"), printelbo=False).resolved(train_model.K)
    trainer = new._build_trainer(cfg)
    stepped = trainer.step_fn(new.state, *trainer.data)
    # keep the per-document fields of the step, every global of the frozen state
    new.state = dataclasses.replace(
        new.state, **{f: getattr(stepped, f) for f in cls._per_doc_fields})
    new.topics = train_model.topics
    return new


# ───────────────── generative sampling (gendoc / gencorp) ─────────────────

def _smoothed(beta: np.ndarray, laplace_smooth: float) -> np.ndarray:
    V = beta.shape[1]
    beta_s = (beta + laplace_smooth) / (1.0 + laplace_smooth * V)
    return beta_s / beta_s.sum(axis=1, keepdims=True)


def _generator(model: TopicModel, laplace_smooth: float):
    """``draw(rng) -> Document``: what every draw of :func:`gendoc` reads
    from a fitted model (its priors, its mean document size and its
    smoothed topic rows, reference modelutils.jl:594-633), taken from the
    model once, and the JAX package's draws from ``rng`` in its order."""
    if laplace_smooth < 0:
        raise ValueError("laplace_smooth parameter must be nonnegative.")
    if model.M == 0:
        raise TopicModelError("gendoc requires a model trained on a nonempty corpus.")
    if isinstance(model, HMTM):
        # an ordered token sequence: the chain (pi, the document's
        # transition columns, z_1..z_N), one token a draw, counts all 1
        # (HMTM.jl:18-39)
        eta = np.asarray(model.eta, np.float64)
        alpha = np.asarray(model.alpha, np.float64)
        K = model.K
        beta_s = _smoothed(np.asarray(model.beta, np.float64), laplace_smooth)
        V, mean_N = beta_s.shape[1], np.mean(model.N)

        def draw_chain(rng) -> Document:
            pi_d = rng.dirichlet(eta)
            theta_d = np.stack([rng.dirichlet(alpha[:, l]) for l in range(K)], axis=1)
            terms, z = [], 0
            for n in range(rng.poisson(mean_N)):
                z = rng.choice(K, p=pi_d if n == 0 else theta_d[:, z])
                terms.append(int(rng.choice(V, p=beta_s[z])) + 1)
            return Document(terms=terms, counts=[1] * len(terms))

        return draw_chain
    if isinstance(model, (LDA, fLDA)):
        alpha = np.asarray(model.alpha, np.float64)
        draw_theta = lambda rng: rng.dirichlet(alpha)
    elif isinstance(model, CTM):   # fCTM included
        mu = np.asarray(model.mu, np.float64)
        sigma = np.asarray(model.sigma, np.float64)

        def draw_theta(rng):
            x = rng.multivariate_normal(mu, sigma)
            e = np.exp(x - x.max())
            return e / e.sum()
    else:
        raise TopicModelError(f"gendoc is not defined for {type(model).__name__} models.")
    beta_s = _smoothed(np.asarray(model.beta, np.float64), laplace_smooth)
    mean_C = np.mean(model.C)

    def draw_mixture(rng) -> Document:
        # token-level (z then w) sampling marginalises to one multinomial
        # over the smoothed mixture theta·beta
        theta = draw_theta(rng)
        mix = theta @ beta_s
        counts = rng.multinomial(rng.poisson(mean_C), mix / mix.sum())
        nz = np.nonzero(counts)[0]
        return Document(terms=(nz + 1).tolist(), counts=counts[nz].tolist())

    return draw_mixture


def gendoc(model: TopicModel, laplace_smooth: float = 0.0, rng=None) -> Document:
    """Sample an artificial document from the fitted generative model
    (reference modelutils.jl:594-633), on the host in NumPy: an ordered
    token chain for HMTM, else one multinomial over the smoothed mixture
    theta·beta.  The reference's CTM variant has a latent NameError
    (``topicdist`` vs ``topic_dist``, modelutils.jl:626); this is the
    corrected form.
    """
    return _generator(model, laplace_smooth)(np.random.default_rng() if rng is None else rng)


def gencorp(model: TopicModel, M: int, laplace_smooth: float = 0.0,
            seed: Optional[int] = None) -> Corpus:
    """Sample an artificial corpus (reference modelutils.jl:642-649)."""
    if M <= 0:
        raise ValueError("corp_size parameter must be a positive integer.")
    if laplace_smooth < 0:
        raise ValueError("laplace_smooth parameter must be nonnegative.")
    rng = np.random.default_rng(seed)
    # the JAX package's draws, one gendoc a document, with the model read once
    draw = _generator(model, laplace_smooth)
    docs = [draw(rng) for _ in range(M)]
    if model.corp is not None:
        vocab, users = dict(model.corp.vocab), dict(model.corp.users)
    else:  # PackedCorpus-built model: placeholder names
        vocab = {j + 1: f"#term{j + 1}" for j in range(model.V)}
        users = {u + 1: f"#user{u + 1}" for u in range(model.U)}
    return Corpus(docs=docs, vocab=vocab, users=users)
