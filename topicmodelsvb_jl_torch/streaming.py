"""Host-streamed training: corpora and per-document state beyond device memory.

PyTorch port of the JAX package's ``streaming.py`` on one process.  The
whole corpus (token arrays) and the per-document variational state (gamma
and Elogtheta for LDA, gimel and zayin for CTPF: the O(M·K) memory that
dominates at production scale) live in host RAM, or with ``state_dir`` in
``.npy`` memory maps.  Each outer CAVI iteration streams fixed-size
document batches through the device:

    for each batch b:
        H2D   terms/counts/doc_mask/state[b] and its scatter plans
        device: the in-memory model's per-chunk E-step body (the same
                hand-written kernels), adding the model's sufficient
                statistics in place into one device buffer for the sweep
        D2H   updated state[b]
    device: the model's global update once

The globals are frozen within a sweep, so streaming changes nothing of the
maths: the trajectory is the in-memory one.  The statistics are added
chunk by chunk in corpus order into buffers that live for the whole
sweep, so the batch partition changes no addition: ``batch_docs`` 8192
and 16384 give bitwise-equal results.

The copies overlap the compute.  Each batch goes through one of two
staging slots: a pinned host buffer and a device buffer for its data,
state and plans, and a pair for its updated state.  The host writes the
batch straight into the pinned buffer (``counts.astype(dtype)`` included),
one host-to-device copy moves it on a copy stream, the compute stream
waits for that copy's event, and the updated state comes back on the copy
stream into pinned memory, stored into the host arrays only after its
event, one batch later.  A slot is reused only after the events of its
previous batch: the host waits for its pinned buffer's last copy, the
copy stream for the compute that last read its device buffer, the compute
for the copy that last read its output buffer.

Scatter plans (``kernels/scatter_rows.build_plan``) are built on the host
the first time a batch is swept, kept in host memory and uploaded with the
batch's data: plans for the whole corpus never live on the device.

Every family streams: :class:`StreamingLDA`, :class:`StreamingCTPF`,
:class:`StreamingFLDA`, :class:`StreamingCTM`, :class:`StreamingFCTM`,
:class:`StreamingHMTM` and :class:`StreamingDTM` (whose [T, K, V] smoother
state stays on the device as its global block).  Each trains by batch
CAVI (``train``) or online SVI (``train_online``), checkpoints
(:meth:`_StreamingModel.save`, :func:`load`, and an auto-checkpoint
cadence), and the file format is the JAX package's: checkpoints cross
between the packages both ways.  A model runs on the CUDA device unless
its caller passes ``device="cpu"``.  float64 runs on the card for every
family (the float64 modes of their kernels, ``kernels._build.
check_dtype``), as it does on the CPU.
"""

from __future__ import annotations

import glob
import json
import math
import os
import shutil
import time
from typing import Optional

import numpy as np
import torch

from .kernels._build import check_dtype
from .kernels.scatter_rows import ScatterPlan, build_plan
from .models import ctm as ctm_mod
from .models import ctpf as ctpf_mod
from .models import dtm as dtm_mod
from .models import fctm as fctm_mod
from .models import flda as flda_mod
from .models import hmtm as hmtm_mod
from .models import lda as lda_mod
from .ops.newton import dirichlet_newton
from .parallel import multihost
from .parallel.mesh import axis_size, is_local, local_block, make_mesh
from .parallel.shard import all_gather, psum, psum_scatter
from .utils.config import TrainConfig
from .utils.numerics import (
    EPSILON, dirichlet_ones, elbo_value, kbn_add, kbn_merge, kbn_psum, kbn_zero,
)

_CKPT_FORMAT = 1
_ALIGN = 256          # byte alignment of each array in a staging buffer
_PLAN_FIELDS = ("rows", "ids", "piece_start", "piece_id", "piece_out", "run_start", "run_id")


def _dtypes(dtype) -> tuple:
    """(torch dtype, numpy dtype, name) of a torch, numpy or string dtype."""
    name = str(dtype).replace("torch.", "")
    if name not in ("float32", "float64"):
        name = np.dtype(dtype).name
    return getattr(torch, name), np.dtype(name), name


def _layout(specs) -> tuple:
    """Byte offsets of ``(name, shape, np dtype)`` arrays packed into one
    buffer, each aligned to ``_ALIGN``, and the buffer's size."""
    offs, o = {}, 0
    for name, shape, dt in specs:
        offs[name] = o
        n = int(np.prod(shape, dtype=np.int64)) * np.dtype(dt).itemsize
        o += -(-n // _ALIGN) * _ALIGN
    return offs, o


def _flatten_plans(plans) -> tuple:
    """The index fields of ``plans`` as one int32 array, and each plan's
    (T, max_id, n_scratch, field lengths)."""
    parts, metas = [], []
    for p in plans:
        metas.append((p.T, p.max_id, p.n_scratch,
                      tuple(int(getattr(p, f).shape[0]) for f in _PLAN_FIELDS)))
        parts += [getattr(p, f).numpy() for f in _PLAN_FIELDS]
    return (np.concatenate(parts) if parts else np.zeros(0, np.int32)), metas


def _plan_views(flat: torch.Tensor, metas) -> list:
    """ScatterPlans whose index tensors are views of ``flat``."""
    out, o = [], 0
    for T, max_id, n_scratch, lens in metas:
        f = {}
        for name, n in zip(_PLAN_FIELDS, lens):
            f[name] = flat[o:o + n]
            o += n
        out.append(ScatterPlan(T=T, max_id=max_id, n_scratch=n_scratch, **f))
    return out


class _Stage:
    """Two staging slots between the host arrays and the device (module
    docstring).  ``upload`` puts a batch's arrays on the device and gives
    views of them and of its output buffers; ``finish`` marks the end of
    the batch's compute and starts the copy of its outputs back;
    ``fetch`` waits for that copy and gives the outputs as NumPy views.

    Off CUDA there is nothing to overlap: ``upload`` copies the arrays
    into fresh CPU tensors and ``fetch`` reads the output tensors.

    Counters: ``h2d_bytes``/``d2h_bytes`` copied and ``wait_s`` the host's
    seconds blocked on copy events."""

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        self.slots = [dict(cap_in=0, cap_out=0, h2d=None, done=None, d2h=None, out=None)
                      for _ in range(2)]
        self.next = 0
        self.reset_counters()
        if self.cuda:
            self.stream = torch.cuda.Stream(device)

    def reset_counters(self) -> None:
        self.h2d_bytes = self.d2h_bytes = 0
        self.wait_s = 0.0

    def _grow(self, s: dict, need_in: int, need_out: int) -> None:
        # only while a first sweep builds its plans: nothing may be in
        # flight on the buffers being replaced
        torch.cuda.synchronize(self.device)
        for key, need in (("in", need_in), ("out", need_out)):
            if need > s[f"cap_{key}"]:
                cap = need                 # a multiple of _ALIGN (_layout)
                s.pop(f"dev_{key}", None)  # freed before its successor is made
                s[f"host_{key}"] = torch.empty(cap, dtype=torch.uint8, pin_memory=True)
                s[f"np_{key}"] = s[f"host_{key}"].numpy()
                s[f"dev_{key}"] = torch.empty(cap, dtype=torch.uint8, device=self.device)
                s[f"cap_{key}"] = cap
        s["h2d"] = s["done"] = s["d2h"] = None

    def _wait(self, event) -> None:
        if event is not None:
            t0 = time.perf_counter()
            event.synchronize()
            self.wait_s += time.perf_counter() - t0

    def upload(self, arrays, out_specs) -> tuple:
        """``arrays``: (name, host array, np dtype) each; ``out_specs``:
        (name, shape, np dtype) each, or None.  Returns (slot, device
        views by name, output views by name or None)."""
        i = self.next
        self.next = 1 - i
        if not self.cuda:
            dev = {n: torch.from_numpy(np.array(a, dtype=dt)) for n, a, dt in arrays}
            out = (None if out_specs is None else
                   {n: torch.empty(shape, dtype=_dtypes(dt)[0]) for n, shape, dt in out_specs})
            self.slots[i]["out"] = out
            return i, dev, out
        s = self.slots[i]
        offs, need_in = _layout([(n, a.shape, dt) for n, a, dt in arrays])
        offs_out, need_out = _layout(out_specs or [])
        if need_in > s["cap_in"] or need_out > s["cap_out"]:
            self._grow(s, need_in, need_out)
        self._wait(s["h2d"])               # the pinned buffer's last copy
        host = s["np_in"]
        for n, a, dt in arrays:
            nb = a.size * np.dtype(dt).itemsize
            np.copyto(host[offs[n]:offs[n] + nb].view(dt).reshape(a.shape), a,
                      casting="unsafe")
        with torch.cuda.stream(self.stream):
            if s["done"] is not None:      # the compute that last read dev_in
                self.stream.wait_event(s["done"])
            s["dev_in"][:need_in].copy_(s["host_in"][:need_in], non_blocking=True)
            s["h2d"] = torch.cuda.Event()
            s["h2d"].record(self.stream)
        self.h2d_bytes += need_in
        compute = torch.cuda.current_stream(self.device)
        compute.wait_event(s["h2d"])
        if s["d2h"] is not None:           # the copy that last read dev_out
            compute.wait_event(s["d2h"])

        def views(buf, offs_, specs):
            return {n: buf[offs_[n]:offs_[n] + int(np.prod(shape, dtype=np.int64))
                           * np.dtype(dt).itemsize].view(_dtypes(dt)[0]).view(shape)
                    for n, shape, dt in specs}

        dev = views(s["dev_in"], offs, [(n, a.shape, dt) for n, a, dt in arrays])
        out = None
        if out_specs is not None:
            out = views(s["dev_out"], offs_out, out_specs)
            s["out_layout"] = (offs_out, out_specs, need_out)
        return i, dev, out

    def finish(self, i: int, download: bool) -> None:
        """The compute of slot ``i``'s batch is queued; with ``download``
        start the copy of its outputs to the host."""
        if not self.cuda:
            return
        s = self.slots[i]
        compute = torch.cuda.current_stream(self.device)
        s["done"] = torch.cuda.Event()
        s["done"].record(compute)
        if not download:
            return
        n = s["out_layout"][2]
        with torch.cuda.stream(self.stream):
            self.stream.wait_event(s["done"])
            s["host_out"][:n].copy_(s["dev_out"][:n], non_blocking=True)
            s["d2h"] = torch.cuda.Event()
            s["d2h"].record(self.stream)
        self.d2h_bytes += n

    def fetch(self, i: int) -> dict:
        """Slot ``i``'s outputs on the host, as NumPy views valid until the
        slot's next ``finish``."""
        s = self.slots[i]
        if not self.cuda:
            return {n: t.numpy() for n, t in s["out"].items()}
        self._wait(s["d2h"])
        offs, specs, _ = s["out_layout"]
        host = s["np_out"]
        return {n: host[offs[n]:offs[n] + int(np.prod(shape, dtype=np.int64))
                        * np.dtype(dt).itemsize].view(dt).reshape(shape)
                for n, shape, dt in specs}


class _StreamingModel:
    """Model-generic host-streaming scaffold.

    Subclasses define:

    * ``_doc_state``: names of the host per-document arrays (``[M_pad,
      ...]`` NumPy attributes);
    * ``_globals``: names of the device global parameters (tensors);
    * ``_counters``: scalar bookkeeping attributes a checkpoint carries;
    * ``_data_arrays(sl)``: the batch's corpus arrays, (name, host array,
      np dtype) each;
    * ``_chunk_plans(data, c)``: a chunk's scatter plans, from its host
      arrays;
    * ``_sweep_prep()``: what every chunk of a sweep shares (tables);
    * ``_run_chunk(prep, d, c, plans, stats)``: one chunk through the
      device, its statistics added into ``stats`` in place; returns its
      new per-document state;
    * ``_zero_stats()`` and ``_global_update(stats)``: the statistics and
      the M-step;
    * ``_elbo_tables()``, ``_elbo_chunk(tables, d, c)`` (a tuple of
      per-chunk terms, each carried in its own compensated pair) and
      ``_elbo_extra(tables)`` (terms added once a sweep, or None);
    * ``_init_globals(gen)``: the constructor's draws.
    """

    _doc_state: tuple = ()
    _globals: tuple = ()
    _counters: tuple = ("elbo", "_svi_t", "_epochs_done", "trained_iters")
    _api_cls: str = ""   # the matching api model class, and the family
    # whether the first online step takes the batch statistic whole (ρ=1);
    # classes whose _svi_init_stats seeds from positive priors set this
    # False so the prior never drops out (see the JAX package)
    _svi_first_step_whole = True

    def _init_common(self, packed, K, batch_docs, chunk_docs, dtype, seed, device,
                     state_dir=None, mesh=None, data_axis="data"):
        if packed.segments is not None:
            raise ValueError(f"{type(self).__name__} takes a dense (non-bucketed) "
                             "PackedCorpus.")
        if int(K) <= 0:
            raise ValueError("number of topics must be a positive integer.")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {str(self.device)!r}: no CUDA device is available; "
                               "pass device='cpu' to run on the CPU")
        self.dtype, self.np_dtype, self._dtype_name = _dtypes(dtype)
        # the state's dtype on this device, before anything is allocated
        # (the storage-vocab axis adds no kernel)
        check_dtype(self._api_cls, self.dtype, self.device)
        self._state_dir = state_dir
        if state_dir is not None:
            os.makedirs(state_dir, exist_ok=True)
        # ── several processes (parallel/multihost) ──
        # Process p owns the p-th L-row slice of every global batch of G =
        # L·n_proc rows: global rows [bG + pL, bG + (p+1)L) for every
        # batch b.  Global batch b is the union of the processes' local
        # batches b, so the batch partition, and the batch-CAVI and online
        # trajectories, do not depend on the process count.  The host state
        # covers the owned rows only; the statistics and the bound are
        # reduced over the processes once a sweep (online: once a global
        # minibatch), gathered and folded in rank order.
        self._nproc, self._pid = multihost.process_count(), multihost.process_index()
        vocab_axis = getattr(self, "vocab_axis", None)
        if (vocab_axis is None and mesh is not None and not is_local(mesh)
                and axis_size(mesh, data_axis) > 1):
            raise ValueError("multi-process streaming takes a local mesh (this process's "
                             "one device, parallel.mesh.make_mesh(local=True)): each "
                             "process streams its own rows, and the processes reduce once "
                             "a sweep")
        if self._nproc > 1:
            if packed.M_pad % self._nproc:
                raise ValueError(f"process count {self._nproc} must divide the padded doc "
                                 f"count {packed.M_pad} (choose docs_multiple accordingly)")
            if batch_docs % self._nproc:
                raise ValueError(f"process count {self._nproc} must divide batch_docs "
                                 f"({batch_docs}), the global batch size")
        self.data_axis = data_axis
        # the processes' mesh the reductions run over (None on one process),
        # and its axes that hold distinct documents: with a vocab axis
        # (StreamingLDA) the caller's mesh, documents over both axes
        self._doc_axes = data_axis if vocab_axis is None else (data_axis, vocab_axis)
        self._proc_mesh = None
        if self._nproc > 1:
            self._proc_mesh = (mesh if vocab_axis is not None and not is_local(mesh)
                               else make_mesh(axis_names=(data_axis,)))
        self.packed = packed
        self.K = int(K)
        self.M, self.V = packed.M, packed.V
        self.M_rows = packed.M_pad // self._nproc
        G = min(int(batch_docs), packed.M_pad)
        self.batch_docs = min(G // self._nproc, self.M_rows)
        self._batch_docs_global = self.batch_docs * self._nproc
        if self.M_rows % self.batch_docs:
            raise ValueError(f"batch_docs must divide the per-process doc rows {self.M_rows} "
                             f"(got {self.batch_docs})")
        self.chunk_docs = min(int(chunk_docs), self.batch_docs)
        if self.batch_docs % self.chunk_docs:
            raise ValueError(f"chunk_docs ({self.chunk_docs}) must divide batch_docs "
                             f"({self.batch_docs})")
        self.seed = int(seed)
        self.elbo = 0.0
        self.topics: Optional[np.ndarray] = None
        self.trace: list = []
        self._svi_t = 0          # SVI step counter (train_online)
        self._epochs_done = 0    # completed online epochs (shuffle replay)
        self.trained_iters = 0   # completed batch-CAVI iterations (k)
        self._svi_stats = None   # running online statistics
        self._stage = _Stage(self.device)
        self._plans = {}         # batch index -> (flat int32 plans, metas, host plans)
        self.plan_build_s = 0.0
        self.plan_cache_bytes = 0
        self._cfg = None
        self._init_globals(torch.Generator().manual_seed(self.seed))

    def _put(self, x) -> torch.Tensor:
        return x.to(self.device, self.dtype)

    def _host_full(self, name, shape, fill):
        """Host per-document array: RAM, or with ``state_dir`` a writable
        ``.npy`` memory map, so the O(M·K) state also lives on disk."""
        if self._state_dir is None:
            return np.full(shape, fill, self.np_dtype)
        from numpy.lib.format import open_memmap

        fname = f"{name}.npy" if self._nproc == 1 else f"{name}.proc{self._pid}.npy"
        a = open_memmap(os.path.join(self._state_dir, fname), mode="w+",
                        dtype=self.np_dtype, shape=shape)
        a[...] = fill
        return a

    def _batches(self):
        for b in range(self.M_rows // self.batch_docs):
            yield b, slice(b * self.batch_docs, (b + 1) * self.batch_docs)

    def _gsl(self, sl) -> slice:
        """Local batch-aligned row slice → global packed-row slice: local
        batch b (rows [bL, (b+1)L)) is the p-th L-row slice of global
        batch b (rows [bG + pL, bG + (p+1)L))."""
        L, G = self.batch_docs, self._batch_docs_global
        b, o = sl.start // L, sl.start % L
        g0 = b * G + self._pid * L + o
        return slice(g0, g0 + (sl.stop - sl.start))

    @staticmethod
    def _local_to_global_rows(n_rows: int, L: int, G: int, pid: int) -> np.ndarray:
        """Global packed row of each of process ``pid``'s ``n_rows`` state
        rows, under local batches of L rows in global batches of G."""
        r = np.arange(n_rows, dtype=np.int64)
        return (r // L) * G + pid * L + (r % L)

    def _reduce_stats(self, stats) -> tuple:
        """The statistics summed over the processes (themselves on one)."""
        if self._proc_mesh is None:
            return stats
        return tuple(psum(x, self._proc_mesh, self._doc_axes) for x in stats)

    def _chunk_slices(self) -> list:
        B = self.chunk_docs
        return [slice(i * B, (i + 1) * B) for i in range(self.batch_docs // B)]

    # ── the corpus side of a batch ──
    def _data_arrays(self, sl) -> list:
        p, g = self.packed, self._gsl(sl)
        return [("terms", p.terms[g], np.int32), ("counts", p.counts[g], self.np_dtype),
                ("doc_mask", p.doc_mask[g], self.np_dtype)]

    def _chunk_plans(self, data: dict, c) -> tuple:
        """One plan over the chunk's token slots with counts > 0."""
        return (build_plan(data["terms"][c], np.asarray(data["counts"][c]) > 0),)

    def _batch_plans(self, b: int, sl) -> tuple:
        """(flat int32 plans, their metas, host ScatterPlans per chunk) of
        batch ``b``, built the first time it is swept and kept."""
        got = self._plans.get(b)
        if got is None:
            t0 = time.perf_counter()
            data = {n: a for n, a, _ in self._data_arrays(sl)}
            host = [self._chunk_plans(data, c) for c in self._chunk_slices()]
            flat, metas = _flatten_plans([p for ps in host for p in ps])
            got = self._plans[b] = (flat, metas, host)
            self.plan_build_s += time.perf_counter() - t0
            self.plan_cache_bytes += flat.nbytes
        return got

    def _stage_batch(self, b: int, sl, plans: bool, out: bool) -> tuple:
        """Upload batch ``b``: (slot, device arrays by name, output buffers
        by name or None, device plans per chunk or None)."""
        arrays = self._data_arrays(sl)
        arrays += [(n, getattr(self, n)[sl], self.np_dtype) for n in self._doc_state]
        if plans:
            flat, metas, host = self._batch_plans(b, sl)
            if self._stage.cuda:
                arrays.append(("__plans__", flat, np.int32))
        out_specs = ([(n, (self.batch_docs,) + getattr(self, n).shape[1:], self.np_dtype)
                      for n in self._doc_state] if out else None)
        slot, dev, outs = self._stage.upload(arrays, out_specs)
        chunk_plans = None
        if plans:
            if self._stage.cuda:
                flat_plans = _plan_views(dev.pop("__plans__"), metas)
                n = len(host[0]) if host else 0
                chunk_plans = [tuple(flat_plans[i * n:(i + 1) * n]) for i in range(len(host))]
            else:
                chunk_plans = host
        return slot, dev, outs, chunk_plans

    def _store(self, slot: int, sl) -> None:
        host = self._stage.fetch(slot)
        for n in self._doc_state:
            getattr(self, n)[sl] = host[n]

    def _run_batch(self, prep, dev, out, plans, stats) -> None:
        for c, ps in zip(self._chunk_slices(), plans):
            for n, x in zip(self._doc_state, self._run_chunk(prep, dev, c, ps, stats)):
                out[n][c] = x

    def _streamed_sweep(self, stats):
        """One full pass: every batch through the device, the state of
        batch b stored once batch b+1 is queued."""
        prep = self._sweep_prep()
        pending = None
        for b, sl in self._batches():
            slot, dev, out, plans = self._stage_batch(b, sl, plans=True, out=True)
            self._run_batch(prep, dev, out, plans, stats)
            self._stage.finish(slot, download=True)
            if pending is not None:
                self._store(*pending)
            pending = (slot, sl)
        if pending is not None:
            self._store(*pending)
        return stats

    def _sweep_elbo(self) -> float:
        """Full-corpus streamed bound: each family's per-chunk terms carried
        in compensated (hi, lo) pairs across the batches, in chunk order,
        plus the terms that enter once a sweep."""
        tables = self._elbo_tables()
        accs = None
        for b, sl in self._batches():
            slot, dev, _, _ = self._stage_batch(b, sl, plans=False, out=False)
            for c in self._chunk_slices():
                parts = self._elbo_chunk(tables, dev, c)
                if accs is None:
                    accs = [kbn_zero(self.dtype, self.device) for _ in parts]
                accs = [kbn_add(a, x) for a, x in zip(accs, parts)]
            self._stage.finish(slot, download=False)
        total = accs[0]
        for a in accs[1:]:
            total = kbn_merge(total, a)
        total = kbn_psum(total, self._proc_mesh, self._doc_axes)
        extra = self._elbo_extra(tables)
        if extra is not None:
            total = kbn_add(total, extra)
        return elbo_value(torch.stack(total))

    def _elbo_extra(self, tables):
        return None

    def _require_whole(self, what: str) -> None:
        if self._nproc > 1:
            raise ValueError(f"{what} needs every document's state, and each of the "
                             f"{self._nproc} processes holds its own rows; save() a "
                             "checkpoint and load it in one process (the directory "
                             "format loads at any process count)")

    def _finalize(self):
        self.topics = lda_mod.topics_ranking(self.beta)

    def _check(self, k, cfg) -> Optional[float]:
        """check_elbo! cadence shared by both training modes; returns the
        ∆elbo when a check ran."""
        if cfg.checkelbo == float("inf") or k % int(cfg.checkelbo):
            return None
        new_elbo = self._sweep_elbo()
        delta = new_elbo - self.elbo
        self.elbo = new_elbo
        self.trace.append((k, new_elbo, delta))
        if cfg.printelbo:
            print(f"{k} ∆elbo: {round(delta, 3)}")
        return delta

    def _global_host(self, name: str) -> np.ndarray:
        """A global as a checkpoint holds it: whole, on the host."""
        return getattr(self, name).detach().cpu().numpy()

    # extra constructor arguments a checkpoint replays (StreamingDTM)
    def _ctor_meta(self) -> dict:
        return {}

    def _ctor_host_arrays(self) -> dict:
        return {}

    # the online statistics as the JAX package's checkpoint leaves
    def _stats_to_leaves(self, stats) -> tuple:
        return stats

    def _leaves_to_stats(self, leaves) -> tuple:
        return leaves

    # ── checkpoint and resume ──
    def save(self, path: str) -> None:
        """One ``.npz`` file with the full streaming run state: the host
        per-document arrays, the device globals, the ELBO trace and the
        online counters and running statistics.  The JAX package's format
        1: the file loads there and back.  On several processes (call it on
        every one), ``path`` is a directory of one ``proc{p}.npz`` a
        process, each with its own rows and their (L, G, p) row map, and
        ``manifest.json`` written last, after a barrier, as the JAX
        package writes it; it loads at any process count."""
        from .checkpoint import packed_fingerprint

        meta = dict(
            format=_CKPT_FORMAT, cls=type(self).__name__, K=self.K,
            batch_docs=self._batch_docs_global, chunk_docs=self.chunk_docs,
            dtype=self._dtype_name, seed=self.seed,
            corpus=packed_fingerprint(self.packed),
            trace=self.trace,
            counters={n: getattr(self, n) for n in self._counters},
            trained=self.topics is not None,
        )
        meta["ctor"] = self._ctor_meta()
        arrays = {f"doc_{n}": getattr(self, n) for n in self._doc_state}
        arrays.update({f"glob_{n}": self._global_host(n) for n in self._globals})
        arrays.update({f"ctor_{k}": np.asarray(v) for k, v in self._ctor_host_arrays().items()})
        if self._svi_stats is not None:
            for i, leaf in enumerate(self._stats_to_leaves(self._svi_stats)):
                arrays[f"svi_{i}"] = leaf.detach().cpu().numpy()
        if self._nproc == 1:
            with open(path, "wb") as f:
                np.savez(f, __meta__=np.frombuffer(json.dumps(meta).encode(), np.uint8),
                         **arrays)
            return
        from .parallel.shard import barrier

        meta["nproc"] = self._nproc
        meta["row_map"] = dict(L=self.batch_docs, G=self._batch_docs_global, pid=self._pid)
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, f"proc{self._pid}.npz"), "wb") as f:
            np.savez(f, __meta__=np.frombuffer(json.dumps(meta).encode(), np.uint8), **arrays)
        barrier(self._proc_mesh)
        if self._pid == 0:
            # a directory a larger process count once used: its stale
            # proc{p >= nproc}.npz would scatter a dead run's rows on load
            for f in glob.glob(os.path.join(path, "proc*.npz")):
                name = os.path.basename(f)[4:-4]
                if not (name.isdigit() and int(name) < self._nproc):
                    os.remove(f)
            manifest = dict(format=_CKPT_FORMAT, nproc=self._nproc, cls=type(self).__name__)
            tmp = os.path.join(path, "manifest.json.tmp")
            with open(tmp, "w") as f:
                json.dump(manifest, f)
            os.replace(tmp, os.path.join(path, "manifest.json"))
        barrier(self._proc_mesh)

    def _restore_doc_shard(self, z, row_map: dict) -> None:
        """Scatter one checkpoint shard's per-document arrays into this
        process's rows.  The shard of process ``pid`` holds the pid-th
        L-row slice of every G-row global batch; the saving and the
        loading process counts (and global batch sizes) may differ."""
        n_saved = z[f"doc_{self._doc_state[0]}"].shape[0]
        g_saved = self._local_to_global_rows(n_saved, int(row_map["L"]), int(row_map["G"]),
                                             int(row_map["pid"]))
        # which saved rows are this process's, and where they land
        L, G = self.batch_docs, self._batch_docs_global
        o = g_saved % G
        sel = (o >= self._pid * L) & (o < (self._pid + 1) * L)
        local = (g_saved[sel] // G) * L + (o[sel] - self._pid * L)
        for n in self._doc_state:
            saved = z[f"doc_{n}"]
            if saved.shape[1:] != getattr(self, n).shape[1:]:
                raise ValueError(f"checkpoint field {n} shape mismatch")
            getattr(self, n)[local] = saved[sel]

    def _restore_common(self, z, meta) -> None:
        for n in self._globals:
            setattr(self, n, torch.as_tensor(np.array(z[f"glob_{n}"])).to(self.device,
                                                                             self.dtype))
        for n, v in meta["counters"].items():
            setattr(self, n, v)
        self.trace = [tuple(t) for t in meta["trace"]]
        n_svi = sum(k.startswith("svi_") for k in z.files)
        if n_svi:
            self._svi_stats = self._leaves_to_stats(tuple(
                torch.as_tensor(np.array(z[f"svi_{i}"])).to(self.device, self.dtype)
                for i in range(n_svi)))
        if meta.get("trained", False):
            self._finalize()

    def _auto_ckpt(self, k, every, ckpt_dir) -> None:
        if not every or not ckpt_dir or k % every:
            return
        os.makedirs(ckpt_dir, exist_ok=True)
        final = os.path.join(ckpt_dir, f"ckpt_iter{k:06d}")
        tmp = final + ".tmp"
        self.save(tmp)            # atomic: a SIGKILL mid-write never
        if self._nproc == 1:      # leaves a torn latest checkpoint
            os.replace(tmp, final)
            return
        # the directory format: save() waited for every process, and
        # process 0 renames (the manifest already certifies the tmp)
        from .parallel.shard import barrier

        if self._pid == 0:
            if os.path.isdir(final):
                shutil.rmtree(final)
            os.replace(tmp, final)
        barrier(self._proc_mesh)

    def to_model(self, runtime=None):
        """The trained streaming state as the matching in-memory ``api``
        model on this model's device: the full post-hoc surface
        (``showtopics``, ``predict``, checkpoints) on the streamed
        parameters.  Use it once the per-document state fits device
        memory; the streamed rows are scattered through the api model's
        length-bucketed row permutation (``_doc_rows``)."""
        self._require_whole("to_model")
        from . import api
        from .utils.config import RuntimeConfig

        cls = getattr(api, self._api_cls)
        rt = runtime if runtime is not None else RuntimeConfig(
            chunk_docs=self.chunk_docs, dtype=self._dtype_name)
        m = cls(self.packed, self.K, runtime=rt, device=self.device, seed=self.seed)
        rows = m._doc_rows()
        vals = {}
        for f in type(m.state).__dataclass_fields__:
            ref = getattr(m.state, f)
            if f == "elbo":
                # host f64 → compensated (hi, lo) pair: hi the rounded
                # value, lo the representation remainder
                hi = torch.tensor(self.elbo, dtype=ref.dtype)
                lo = torch.tensor(self.elbo - float(hi), dtype=ref.dtype)
                vals[f] = torch.stack([hi, lo]).to(ref.device)
            elif f in self._doc_state:
                out = ref.detach().cpu().numpy().copy()
                src = getattr(self, f)
                if src.ndim >= 2 and src.shape[1] != out.shape[1]:
                    # per-token state (tau): within-document order is
                    # kept, columns past a document's length are pads
                    out[rows] = src[: self.M, : out.shape[1]]
                else:
                    out[rows] = src[: self.M]
                vals[f] = torch.as_tensor(out).to(ref.device)
            else:
                vals[f] = getattr(self, f).to(ref.device, ref.dtype)
        m.state = type(m.state)(**vals)
        if self.topics is not None:
            m._finalize()
        return m

    # ── the training loops every family delegates to ──
    def _compile(self, cfg) -> None:
        self._cfg = cfg

    def _train_loop(self, cfg, checkpoint_every, checkpoint_dir):
        """Batch CAVI: a full streamed sweep, one global update, the
        check_elbo! cadence, optional auto-checkpoints."""
        cfg.validate()
        self._compile(cfg)
        if cfg.checkelbo <= cfg.iter and not self.trace:
            self.elbo = self._sweep_elbo()
        # k continues past a resume (trained_iters is a counter), so trace
        # rows and ckpt_iterNNNNNN names never repeat
        k0 = self.trained_iters
        for k in range(k0 + 1, k0 + cfg.iter + 1):
            stats = self._reduce_stats(self._streamed_sweep(self._zero_stats()))
            self._global_update(stats)
            self.trained_iters = k
            delta = self._check(k, cfg)
            self._auto_ckpt(k, checkpoint_every, checkpoint_dir)
            if delta is not None and delta < cfg.tol:
                break
        self._finalize()
        return self

    def _svi_init_stats(self):
        """Initial running statistics of ``train_online`` (override to seed
        from priors rather than zeros)."""
        return self._zero_stats()

    def _train_online_loop(self, cfg, tau0, kappa, shuffle_seed, checkpoint_every,
                           checkpoint_dir):
        """Online (stochastic) variational training.

        After each document minibatch the running statistics are blended
        with the batch's corpus-scaled statistics at step size
        ``ρ_t = (τ0 + t)^(−κ)`` (Hoffman et al.'s SVI schedule over the
        model's closed-form M-step) and the globals update at once.
        ``kappa`` in (0.5, 1] meets the Robbins–Monro conditions.  Each
        batch is scaled by M / (its real documents), and batches of
        padding alone are dropped.  The bound is checked per epoch; a
        resumed run replays the shuffle past its completed epochs, so the
        batch schedule, and the trajectory, continue exactly."""
        if not (0.5 < kappa <= 1.0):
            raise ValueError("kappa must be in (0.5, 1].")
        cfg.validate()
        self._compile(cfg)
        p = self.packed
        n_batches = self.M_rows // self.batch_docs
        # global batch b is every process's local batch b: its real
        # documents are summed over the processes
        real_docs = np.array([
            float(p.doc_mask[self._gsl(slice(b * self.batch_docs,
                                             (b + 1) * self.batch_docs))].sum())
            for b in range(n_batches)])
        if self._proc_mesh is not None:
            real_docs = psum(torch.as_tensor(real_docs, device=self.device),
                             self._proc_mesh, self._doc_axes).cpu().numpy()
        live = np.nonzero(real_docs > 0)[0]
        if self._svi_stats is None:
            self._svi_stats = self._svi_init_stats()
        # seed the bound as train() does, so the first ∆elbo is a real one
        if cfg.checkelbo <= cfg.iter and not self.trace:
            self.elbo = self._sweep_elbo()
        rng = np.random.default_rng(shuffle_seed)
        for _ in range(self._epochs_done):   # resume: replay the schedule
            rng.permutation(len(live))
        for _ in range(cfg.iter):
            order = live[rng.permutation(len(live))]
            for b in order:
                b = int(b)
                scale = float(self.M) / real_docs[b]
                sl = slice(b * self.batch_docs, (b + 1) * self.batch_docs)
                batch_stats = self._zero_stats()
                slot, dev, out, plans = self._stage_batch(b, sl, plans=True, out=True)
                self._run_batch(self._sweep_prep(), dev, out, plans, batch_stats)
                self._stage.finish(slot, download=True)
                batch_stats = self._reduce_stats(batch_stats)
                self._store(slot, sl)
                # a zero-seeded running statistic takes the first batch
                # whole (ρ=1); prior-seeded classes keep the schedule
                t = self._svi_t
                rho = (1.0 if (t == 0 and self._svi_first_step_whole)
                       else (tau0 + t) ** (-kappa))
                self._svi_stats = tuple((1.0 - rho) * S + rho * scale * s
                                        for S, s in zip(self._svi_stats, batch_stats))
                self._global_update(self._svi_stats)
                self._svi_t = t + 1
            self._epochs_done += 1
            self._check(self._epochs_done, cfg)
            self._auto_ckpt(self._epochs_done, checkpoint_every, checkpoint_dir)
        self._finalize()
        return self

    def _train_cfg(self, **kw) -> TrainConfig:
        return TrainConfig(**kw).resolved(self.K)

    def train(self, iter: int = 150, tol: float = 1.0, niter: int = 1000,
              ntol: Optional[float] = None, viter: int = 10, vtol: Optional[float] = None,
              checkelbo: float = 1, printelbo: bool = True, checkpoint_every: int = 0,
              checkpoint_dir: Optional[str] = None):
        """Batch CAVI with the reference's train! arguments and defaults,
        auto-checkpointing every ``checkpoint_every`` iterations into
        ``checkpoint_dir`` when both are set."""
        cfg = self._train_cfg(iter=iter, tol=tol, niter=niter, ntol=ntol, viter=viter,
                              vtol=vtol, checkelbo=checkelbo, printelbo=printelbo)
        return self._train_loop(cfg, checkpoint_every, checkpoint_dir)

    def train_online(self, epochs: int = 1, tau0: float = 64.0, kappa: float = 0.7,
                     viter: int = 10, vtol: Optional[float] = None, niter: int = 1000,
                     ntol: Optional[float] = None, checkelbo: float = 1,
                     printelbo: bool = True, shuffle_seed: int = 0,
                     checkpoint_every: int = 0, checkpoint_dir: Optional[str] = None):
        """Online SVI (:meth:`_train_online_loop`), the bound checked per
        epoch."""
        cfg = self._train_cfg(iter=epochs, niter=niter, ntol=ntol, viter=viter, vtol=vtol,
                              checkelbo=checkelbo, printelbo=printelbo)
        return self._train_online_loop(cfg, tau0, kappa, shuffle_seed, checkpoint_every,
                                       checkpoint_dir)


# ─────────────────────────── StreamingLDA ───────────────────────────

class StreamingLDA(_StreamingModel):
    """LDA trained with the corpus and per-document state on the host.

    ``packed`` is a dense :class:`~.ops.packing.PackedCorpus` (host NumPy,
    or the memory maps of :func:`~.ops.packing.load_packed`).
    ``batch_docs`` bounds device memory: the globals and the [V, K]
    statistic, two staged batches and one chunk's [B, L, K] rows,
    independent of the corpus size.  The trajectory is the in-memory
    one."""

    _doc_state = ("gamma", "Elogtheta", "Elogtheta_old")
    _globals = ("beta", "beta_old", "alpha")
    _api_cls = "LDA"

    def __init__(self, packed, K: int, batch_docs: int = 8192, chunk_docs: int = 1024,
                 dtype=torch.float32, seed: int = 0, state_dir: Optional[str] = None,
                 device="cuda", mesh=None,
                 data_axis: str = "data", vocab_axis: Optional[str] = None):
        """``vocab_axis`` (a mesh over every process carrying that axis)
        also shards beta's storage: each process holds its ``[K, V/n]``
        block, gathered whole for the E-step and the bound, and the sweep's
        statistic is summed over the processes keeping the process's block
        (``psum_scatter``); the documents shard over the data and vocab
        axes together, each process streaming its own rows."""
        if vocab_axis is not None and (
                mesh is None or vocab_axis not in tuple(mesh.mesh_dim_names or ())):
            raise ValueError("vocab_axis needs a mesh carrying that axis")
        self.vocab_axis = vocab_axis
        self._init_common(packed, K, batch_docs, chunk_docs, dtype, seed, device, state_dir,
                          mesh, data_axis)
        el0 = -sum(1.0 / i for i in range(1, self.K))   # ψ(1) − ψ(K) = −H_{K−1}
        shape = (self.M_rows, self.K)
        self.gamma = self._host_full("gamma", shape, 1.0)
        self.Elogtheta = self._host_full("Elogtheta", shape, el0)
        self.Elogtheta_old = self._host_full("Elogtheta_old", shape, el0)

    @property
    def _tp(self) -> bool:
        """beta is sharded over the vocab axis of the processes' mesh."""
        return self.vocab_axis is not None and self._proc_mesh is not None

    def _whole(self, beta) -> torch.Tensor:
        return all_gather(beta, self._proc_mesh, self.vocab_axis, dim=1) if self._tp else beta

    def _init_globals(self, gen):
        # the in-memory init's draw (models/lda.init, LDA.jl:24-47)
        beta = dirichlet_ones(gen, self.V, (self.K,), self.dtype)
        if self._tp:
            beta = torch.as_tensor(local_block(beta.numpy(), self._proc_mesh,
                                               self.vocab_axis, dim=1))
        self.beta = self._put(beta)
        self.beta_old = self.beta
        self.alpha = torch.ones((self.K,), dtype=self.dtype, device=self.device)

    def _zero_stats(self):
        z = lambda *s: torch.zeros(s, dtype=self.dtype, device=self.device)
        return z(self.V, self.K), z(self.K)

    def _sweep_prep(self):
        return (self._whole(self.beta) + EPSILON).T.contiguous()

    def _run_chunk(self, betaT, d, c, plans, stats):
        bt, es = stats
        g2, el2, elo2, el_part = lda_mod.sweep_chunk(
            betaT, self.alpha, d["terms"][c], d["counts"][c], d["doc_mask"][c],
            d["gamma"][c], d["Elogtheta"][c], d["Elogtheta_old"][c], plans[0], bt,
            self._cfg.viter, self._cfg.vtol)
        es.add_(el_part)   # plain-accumulated, as in the JAX streaming path
        return g2, el2, elo2

    def _reduce_stats(self, stats) -> tuple:
        if not self._tp:
            return super()._reduce_stats(stats)
        # the statistic summed over every process, each keeping its block
        bt, es = stats
        mesh = self._proc_mesh
        return (psum(psum_scatter(bt, mesh, self.vocab_axis), mesh, self.data_axis),
                psum(es, mesh, self._doc_axes))

    def _global_update(self, stats):
        bt, es = stats
        self.beta_old = self.beta
        if self._tp:
            row_sum = psum(torch.sum(bt, dim=0), self._proc_mesh, self.vocab_axis)
            self.beta = (bt.T / row_sum[:, None]).contiguous()
            self.alpha = dirichlet_newton(self.alpha, es, float(self.M), self._cfg.niter,
                                          self._cfg.ntol)
            return
        self.beta, self.alpha = lda_mod.global_update(
            bt, self.alpha, es, float(self.M), self._cfg.niter, self._cfg.ntol)

    def _svi_init_stats(self):
        # the running statistics start from one pass worth of the beta prior
        return self.beta.T.contiguous(), torch.zeros((self.K,), dtype=self.dtype,
                                                     device=self.device)

    def _elbo_tables(self):
        return lda_mod.elbo_tables(self._whole(self.beta), self._whole(self.beta_old),
                                   self.alpha)

    def _elbo_chunk(self, tables, d, c):
        return lda_mod.elbo_chunk(tables, d["terms"][c], d["counts"][c], d["doc_mask"][c],
                                  d["gamma"][c], d["Elogtheta"][c], d["Elogtheta_old"][c])

    def _finalize(self):
        self.topics = lda_mod.topics_ranking(self._whole(self.beta))

    def _global_host(self, name: str) -> np.ndarray:
        x = getattr(self, name)
        return (self._whole(x) if name != "alpha" else x).detach().cpu().numpy()

    def _stats_to_leaves(self, stats) -> tuple:
        bt, es = stats
        if self._tp:
            bt = all_gather(bt, self._proc_mesh, self.vocab_axis, dim=0)
        return bt, es


# ─────────────────────────── StreamingCTPF ───────────────────────────

class StreamingCTPF(_StreamingModel):
    """CTPF trained with the corpus and per-document state on the host: the
    host keeps gimel/zayin and their olds (the O(M·K) memory), the device
    the Gamma globals alef/bet/dalet/he/vav/het.  The trajectory is the
    in-memory one."""

    _doc_state = ("gimel", "gimel_old", "zayin", "zayin_old")
    _globals = ("alef", "alef_old", "bet", "bet_old", "dalet", "dalet_old",
                "he", "he_old", "vav", "vav_old", "het", "het_old")
    _api_cls = "CTPF"

    def __init__(self, packed, K: int, batch_docs: int = 8192, chunk_docs: int = 1024,
                 dtype=torch.float32, seed: int = 0, state_dir: Optional[str] = None,
                 device="cuda", mesh=None,
                 data_axis: str = "data"):
        if packed.readers is None or packed.ratings is None:
            raise ValueError("StreamingCTPF needs reader arrays "
                             "(pack with with_readers=True).")
        self.U = packed.U
        self.U_seg = max(packed.U, 1)
        self._init_common(packed, K, batch_docs, chunk_docs, dtype, seed, device, state_dir,
                          mesh, data_axis)
        shape = (self.M_rows, self.K)
        for n in self._doc_state:
            setattr(self, n, self._host_full(n, shape, 1.0))

    def _init_globals(self, gen):
        # the in-memory init's draw (models/ctpf.init, CTPF.jl:81-103)
        alef = self._put(torch.exp(dirichlet_ones(gen, self.V, (self.K,), self.dtype) - 0.5))
        ones = lambda *s: torch.ones(s, dtype=self.dtype, device=self.device)
        self.alef, self.alef_old = alef, alef
        for n in ("bet", "dalet", "vav", "het"):
            setattr(self, n, ones(self.K))
            setattr(self, n + "_old", ones(self.K))
        self.he = ones(self.K, self.U_seg)
        self.he_old = self.he

    def _data_arrays(self, sl) -> list:
        p, g = self.packed, self._gsl(sl)
        return super()._data_arrays(sl) + [("readers", p.readers[g], np.int32),
                                           ("ratings", p.ratings[g], self.np_dtype)]

    def _chunk_plans(self, data, c) -> tuple:
        return (build_plan(data["terms"][c], np.asarray(data["counts"][c]) > 0),
                build_plan(data["readers"][c], np.asarray(data["ratings"][c]) > 0))

    def _zero_stats(self):
        z = lambda *s: torch.zeros(s, dtype=self.dtype, device=self.device)
        return z(self.V, self.K), z(self.U_seg, self.K), z(self.K), z(self.K)

    def _sweep_prep(self):
        return ctpf_mod.estep_tables(self)

    def _run_chunk(self, tables, d, c, plans, stats):
        at, ht, gs, zs = stats
        *out, gs_part, zs_part = ctpf_mod.sweep_chunk(
            tables, d["terms"][c], d["counts"][c], d["readers"][c], d["ratings"][c],
            d["doc_mask"][c], d["gimel"][c], d["gimel_old"][c], d["zayin"][c],
            d["zayin_old"][c], plans[0], plans[1], at, ht, self._cfg.viter, self._cfg.vtol)
        gs.add_(gs_part)
        zs.add_(zs_part)
        return out

    def _global_update(self, stats):
        new = ctpf_mod.global_update(*stats, self.bet, self.vav, self.U)
        for n, v in zip(("alef", "bet", "dalet", "he", "vav", "het"), new):
            setattr(self, n + "_old", getattr(self, n))
            setattr(self, n, v)

    def _elbo_tables(self):
        return ctpf_mod.elbo_tables(self, self.U)

    def _elbo_chunk(self, tb, d, c):
        return ctpf_mod.elbo_chunk(tb, d["terms"][c], d["counts"][c], d["readers"][c],
                                   d["ratings"][c], d["doc_mask"][c], d["gimel"][c],
                                   d["gimel_old"][c], d["zayin"][c], d["zayin_old"][c])

    def _elbo_extra(self, tb):
        # the data-independent alef/he terms enter once a sweep
        return ctpf_mod.global_terms(tb)

    def _finalize(self):
        # Ebeta = alef ./ bet (CTPF.jl:378)
        self.topics = lda_mod.topics_ranking(self.alef / self.bet[:, None])

    def scores(self, docs: Optional[slice] = None) -> np.ndarray:
        """Recommendation scores Eeta'·(Etheta+Eepsilon) (CTPF.jl:381-386)
        for a document slice (default: the whole corpus; [M, U] is host
        memory, so pass a slice to bound it)."""
        self._require_whole("scores")
        sl = docs if docs is not None else slice(0, self.M)
        host = lambda t: t.detach().cpu().numpy()
        Eeta = host(self.he / self.vav[:, None])                   # [K, U]
        Eth = self.gimel[sl] / host(self.dalet)[None, :]
        Eep = self.zayin[sl] / host(self.het)[None, :]
        return ((Eth + Eep) @ Eeta)[:, : self.U]

    def train(self, iter: int = 150, tol: float = 1.0, viter: int = 10,
              vtol: Optional[float] = None, checkelbo: float = 1, printelbo: bool = True,
              checkpoint_every: int = 0, checkpoint_dir: Optional[str] = None):
        """train! (CTPF.jl:344-376): no niter/ntol (no Newton steps)."""
        cfg = self._train_cfg(iter=iter, tol=tol, viter=viter, vtol=vtol,
                              checkelbo=checkelbo, printelbo=printelbo)
        return self._train_loop(cfg, checkpoint_every, checkpoint_dir)

    def train_online(self, epochs: int = 1, tau0: float = 64.0, kappa: float = 0.7,
                     viter: int = 10, vtol: Optional[float] = None, checkelbo: float = 1,
                     printelbo: bool = True, shuffle_seed: int = 0,
                     checkpoint_every: int = 0, checkpoint_dir: Optional[str] = None):
        """Online SVI CTPF: the Gamma global updates (CTPF.jl:251-305) are
        closed-form in the statistics, so the blend is a running average of
        corpus-scaled minibatch statistics."""
        cfg = self._train_cfg(iter=epochs, viter=viter, vtol=vtol, checkelbo=checkelbo,
                              printelbo=printelbo)
        return self._train_online_loop(cfg, tau0, kappa, shuffle_seed, checkpoint_every,
                                       checkpoint_dir)


# ─────────────────────────── StreamingFLDA ───────────────────────────

class StreamingFLDA(_StreamingModel):
    """fLDA trained with the corpus and per-document state on the host: the
    host keeps gamma/Elogtheta and the per-token tau [M_pad, L] (the memory
    that makes in-memory fLDA infeasible on long corpora), the device
    eta/alpha/kappa/beta."""

    _doc_state = ("gamma", "Elogtheta", "Elogtheta_old", "tau", "tau_old")
    _globals = ("eta", "alpha", "kappa", "kappa_old", "beta", "beta_old")
    _api_cls = "fLDA"

    def __init__(self, packed, K: int, batch_docs: int = 8192, chunk_docs: int = 1024,
                 dtype=torch.float32, seed: int = 0, state_dir: Optional[str] = None,
                 device="cuda", mesh=None,
                 data_axis: str = "data"):
        self._init_common(packed, K, batch_docs, chunk_docs, dtype, seed, device, state_dir,
                          mesh, data_axis)
        el0 = -sum(1.0 / i for i in range(1, self.K))
        shape, L = (self.M_rows, self.K), packed.L
        self.gamma = self._host_full("gamma", shape, 1.0)
        self.Elogtheta = self._host_full("Elogtheta", shape, el0)
        self.Elogtheta_old = self._host_full("Elogtheta_old", shape, el0)
        self.tau = self._host_full("tau", (self.M_rows, L), 0.5)
        self.tau_old = self._host_full("tau_old", (self.M_rows, L), 0.5)
        self._C_total = float(np.asarray(packed.C, np.float64).sum())

    def _init_globals(self, gen):
        # the in-memory init's draws, beta then kappa (models/flda.init)
        self.beta = self._put(dirichlet_ones(gen, self.V, (self.K,), self.dtype))
        self.beta_old = self.beta
        self.kappa = self._put(dirichlet_ones(gen, self.V, (), self.dtype))
        self.kappa_old = self.kappa
        self.eta = torch.tensor(0.5, dtype=self.dtype, device=self.device)
        self.alpha = torch.ones((self.K,), dtype=self.dtype, device=self.device)

    def _zero_stats(self):
        z = lambda *s: torch.zeros(s, dtype=self.dtype, device=self.device)
        # beta_temp and kappa_temp share one [V, K+1] scatter
        return z(self.V, self.K + 1), z(self.K), z()

    def _stats_to_leaves(self, stats):
        stat, es, tc = stats
        return stat[:, : self.K], stat[:, self.K], es, tc

    def _leaves_to_stats(self, leaves):
        bt, kt, es, tc = leaves
        return torch.cat([bt, kt[:, None]], dim=1), es, tc

    def _sweep_prep(self):
        return torch.log(self.beta + EPSILON).T.contiguous()

    def _run_chunk(self, logbetaT, d, c, plans, stats):
        stat, es, tc = stats
        *out, el_part, tau_part = flda_mod.sweep_chunk(
            logbetaT, self.kappa, self.alpha, self.eta, d["terms"][c], d["counts"][c],
            d["doc_mask"][c], d["gamma"][c], d["Elogtheta"][c], d["Elogtheta_old"][c],
            d["tau"][c], d["tau_old"][c], plans[0], stat, self._cfg.viter, self._cfg.vtol)
        es.add_(el_part)
        tc.add_(tau_part)
        return out

    def _global_update(self, stats):
        stat, es, tc = stats
        eta, alpha, kappa, beta = flda_mod.global_update(
            stat, self.alpha, es, tc, float(self.M), self._C_total, self._cfg.niter,
            self._cfg.ntol)
        self.beta_old, self.beta = self.beta, beta
        self.kappa_old, self.kappa = self.kappa, kappa
        self.eta, self.alpha = eta, alpha

    def _elbo_tables(self):
        return flda_mod.elbo_tables(self.beta, self.beta_old, self.kappa, self.alpha, self.eta)

    def _elbo_chunk(self, tables, d, c):
        return flda_mod.elbo_chunk(tables, d["terms"][c], d["counts"][c], d["doc_mask"][c],
                                   d["gamma"][c], d["Elogtheta"][c], d["Elogtheta_old"][c],
                                   d["tau"][c], d["tau_old"][c])


# ─────────────────────────── StreamingCTM ───────────────────────────

class StreamingCTM(_StreamingModel):
    """CTM trained with the corpus and per-document state (lambda / vsq /
    logzeta) on the host, mu/sigma/beta on the device.  The E-step is the
    in-memory model's plain PyTorch body (``ctm.estep_chunk``); the bound's
    token terms go through ``lda_elbo_tok``."""

    _doc_state = ("lam", "lam_old", "vsq", "logzeta")
    _globals = ("mu", "sigma", "invsigma", "beta", "beta_old")
    _api_cls = "CTM"
    _svi_first_step_whole = False

    def __init__(self, packed, K: int, batch_docs: int = 8192, chunk_docs: int = 2048,
                 dtype=torch.float32, seed: int = 0, state_dir: Optional[str] = None,
                 device="cuda", mesh=None,
                 data_axis: str = "data"):
        self._init_common(packed, K, batch_docs, chunk_docs, dtype, seed, device, state_dir,
                          mesh, data_axis)
        self._init_moments()

    def _init_moments(self):
        shape = (self.M_rows, self.K)
        self.lam = self._host_full("lam", shape, 0.0)
        self.lam_old = self._host_full("lam_old", shape, 0.0)
        self.vsq = self._host_full("vsq", shape, 1.0)
        self.logzeta = self._host_full("logzeta", (self.M_rows,), 0.5)

    def _init_globals(self, gen):
        # the in-memory init's draw (models/ctm.init, CTM.jl:27-52)
        self.beta = self._put(dirichlet_ones(gen, self.V, (self.K,), self.dtype))
        self.beta_old = self.beta
        self.mu = torch.zeros((self.K,), dtype=self.dtype, device=self.device)
        self.sigma = torch.eye(self.K, dtype=self.dtype, device=self.device)
        self.invsigma = self.sigma

    def _zero_stats(self):
        z = lambda *s: torch.zeros(s, dtype=self.dtype, device=self.device)
        return z(self.V, self.K), z(self.K), z(self.K), z(self.K, self.K)

    def _svi_init_stats(self):
        # seeded from the strictly positive prior draw of beta and the
        # constructor moments (vsq = 1, lam = 0): the blended beta never
        # gets an exactly-zero column, whose raw log would NaN the E-step
        z = lambda *s: torch.zeros(s, dtype=self.dtype, device=self.device)
        return (self.beta.T.contiguous(),
                torch.full((self.K,), float(self.M), dtype=self.dtype, device=self.device),
                z(self.K), z(self.K, self.K))

    def _sweep_prep(self):
        return torch.log(self.beta).T.contiguous()   # raw log (CTM.jl:177)

    def _run_chunk(self, logbetaT, d, c, plans, stats):
        bt, vs, ls, lo = stats
        cfg = self._cfg
        *out, ls_part, vs_part, lo_part = ctm_mod.sweep_chunk(
            logbetaT, self.mu, self.invsigma, d["terms"][c], d["counts"][c], d["doc_mask"][c],
            d["lam"][c], d["lam_old"][c], d["vsq"][c], d["logzeta"][c], plans[0], bt,
            cfg.viter, cfg.vtol, cfg.niter, cfg.ntol)
        ls.add_(ls_part)
        vs.add_(vs_part)
        lo.add_(lo_part)
        return out

    def _global_update(self, stats):
        bt, vs, ls, lo = stats
        mu, sigma, invsigma, beta = ctm_mod.global_update(self, bt, vs, ls, lo,
                                                          float(self.M), False)
        self.beta_old, self.beta = self.beta, beta
        self.mu, self.sigma, self.invsigma = mu, sigma, invsigma

    def _elbo_tables(self):
        return (*ctm_mod.elbo_tables(self), ctm_mod.logdet_invsigma(self), self)

    def _elbo_chunk(self, tables, d, c):
        return ctm_mod.elbo_chunk(tables, d["terms"][c], d["counts"][c], d["doc_mask"][c],
                                  d["lam"][c], d["lam_old"][c], d["vsq"][c], d["logzeta"][c])


# ─────────────────────────── StreamingFCTM ───────────────────────────

class StreamingFCTM(StreamingCTM):
    """fCTM trained with the corpus and per-document state (lambda / vsq /
    logzeta and the per-token tau [M_pad, L]) on the host,
    eta/mu/sigma/kappa/beta on the device."""

    _doc_state = ("lam", "lam_old", "vsq", "logzeta", "tau", "tau_old")
    _globals = ("eta", "mu", "sigma", "invsigma", "kappa", "kappa_old", "beta", "beta_old")
    _api_cls = "fCTM"

    def __init__(self, packed, K: int, batch_docs: int = 8192, chunk_docs: int = 2048,
                 dtype=torch.float32, seed: int = 0, state_dir: Optional[str] = None,
                 device="cuda", mesh=None,
                 data_axis: str = "data"):
        self._init_common(packed, K, batch_docs, chunk_docs, dtype, seed, device, state_dir,
                          mesh, data_axis)
        self._init_moments()
        self.tau = self._host_full("tau", (self.M_rows, packed.L), 0.5)
        self.tau_old = self._host_full("tau_old", (self.M_rows, packed.L), 0.5)

    def _init_globals(self, gen):
        # the in-memory init's draws, beta then kappa (models/fctm.init)
        super()._init_globals(gen)
        self.kappa = self._put(dirichlet_ones(gen, self.V, (), self.dtype))
        self.kappa_old = self.kappa
        self.eta = torch.tensor(0.5, dtype=self.dtype, device=self.device)

    def _zero_stats(self):
        z = lambda *s: torch.zeros(s, dtype=self.dtype, device=self.device)
        # beta_temp and kappa_temp share one [V, K+1] scatter
        return z(self.V, self.K + 1), z(self.K), z(self.K), z(self.K, self.K)

    def _stats_to_leaves(self, stats):
        stat, *rest = stats
        return (stat[:, : self.K], stat[:, self.K], *rest)

    def _leaves_to_stats(self, leaves):
        bt, kt, *rest = leaves
        return (torch.cat([bt, kt[:, None]], dim=1), *rest)

    def _svi_init_stats(self):
        # prior-seeded like StreamingCTM (positive beta/kappa columns)
        z = lambda *s: torch.zeros(s, dtype=self.dtype, device=self.device)
        return (torch.cat([self.beta.T, self.kappa[:, None]], dim=1),
                torch.full((self.K,), float(self.M), dtype=self.dtype, device=self.device),
                z(self.K), z(self.K, self.K))

    def _sweep_prep(self):
        return torch.log(self.beta + EPSILON).T.contiguous()   # fCTM.jl:232

    def _run_chunk(self, logbetaT, d, c, plans, stats):
        stat, vs, ls, lo = stats
        cfg = self._cfg
        *out, ls_part, vs_part, lo_part = fctm_mod.sweep_chunk(
            logbetaT, self.kappa, self.eta, self.mu, self.invsigma, d["terms"][c],
            d["counts"][c], d["doc_mask"][c], d["lam"][c], d["lam_old"][c], d["vsq"][c],
            d["logzeta"][c], d["tau"][c], d["tau_old"][c], plans[0], stat,
            cfg.viter, cfg.vtol, cfg.niter, cfg.ntol)
        ls.add_(ls_part)
        vs.add_(vs_part)
        lo.add_(lo_part)
        return out

    def _global_update(self, stats):
        stat, vs, ls, lo = stats
        mu, sigma, invsigma, kappa, beta = fctm_mod.global_update(self, stat, vs, ls, lo,
                                                                  float(self.M), False)
        self.beta_old, self.beta = self.beta, beta
        self.kappa_old, self.kappa = self.kappa, kappa
        self.mu, self.sigma, self.invsigma = mu, sigma, invsigma

    def _elbo_tables(self):
        return fctm_mod.elbo_tables(self)

    def _elbo_chunk(self, tables, d, c):
        return fctm_mod.elbo_chunk(tables, d["terms"][c], d["counts"][c], d["doc_mask"][c],
                                   d["lam"][c], d["lam_old"][c], d["vsq"][c], d["logzeta"][c],
                                   d["tau"][c], d["tau_old"][c])


# ─────────────────────────── StreamingHMTM ───────────────────────────

class StreamingHMTM(_StreamingModel):
    """HMTM trained with the corpus and per-document state on the host: the
    host keeps tau [M, K] and the per-document transition Dirichlets gamma
    [M, K, K] (the O(M·K²) memory that dominates HMTM at scale), the device
    eta/alpha/beta.  Needs an order-preserving corpus (all counts 1:
    ``ops.packing.unit_counts`` for synthetic packed data)."""

    _doc_state = ("tau", "gamma")
    _globals = ("eta", "alpha", "beta")
    _api_cls = "HMTM"

    def __init__(self, packed, K: int, batch_docs: int = 8192, chunk_docs: int = 1024,
                 dtype=torch.float32, seed: int = 0, state_dir: Optional[str] = None,
                 device="cuda", mesh=None,
                 data_axis: str = "data"):
        hmtm_mod.check_order_preserving(packed)
        self._init_common(packed, K, batch_docs, chunk_docs, dtype, seed, device, state_dir,
                          mesh, data_axis)
        self.tau = self._host_full("tau", (self.M_rows, self.K), 1.0)
        self.gamma = self._host_full("gamma", (self.M_rows, self.K, self.K), 1.0)

    def _init_globals(self, gen):
        # the in-memory init's draw (models/hmtm.init, HMTM.jl:26-32)
        ones = lambda *s: torch.ones(s, dtype=self.dtype, device=self.device)
        self.eta, self.alpha = ones(self.K), ones(self.K, self.K)
        self.beta = self._put(dirichlet_ones(gen, self.V, (self.K,), self.dtype))

    def _zero_stats(self):
        z = lambda *s: torch.zeros(s, dtype=self.dtype, device=self.device)
        return z(self.V, self.K), z(self.K), z(self.K, self.K)

    def _sweep_prep(self):
        return (self.beta.T + EPSILON).contiguous()

    def _run_chunk(self, betaT_eps, d, c, plans, stats):
        bt, ps, ts = stats
        tau2, gamma2, pi_part, th_part = hmtm_mod.sweep_chunk(
            betaT_eps, self.eta, self.alpha, d["terms"][c], d["counts"][c], d["doc_mask"][c],
            d["tau"][c], d["gamma"][c], plans[0], bt, self._cfg.viter, self._cfg.vtol)
        ps.add_(pi_part)
        ts.add_(th_part)
        return tau2, gamma2

    def _global_update(self, stats):
        bt, ps, ts = stats
        self.eta, self.alpha, self.beta = hmtm_mod.global_update(
            self.eta, self.alpha, bt, (ps, torch.zeros_like(ps)), (ts, torch.zeros_like(ts)),
            float(self.M), self._cfg.niter, self._cfg.ntol)

    def _elbo_tables(self):
        return hmtm_mod.elbo_tables(self.beta, self.eta, self.alpha)

    def _elbo_chunk(self, tables, d, c):
        return (hmtm_mod.elbo_chunk(tables, d["terms"][c], d["counts"][c], d["doc_mask"][c],
                                    d["tau"][c], d["gamma"][c]),)


# ─────────────────────────── StreamingDTM ───────────────────────────

class StreamingDTM(_StreamingModel):
    """DTM trained with the corpus and per-document state on the host.

    The [T, K, V] smoother state (alpha/betahat/mbeta/vbeta/v_filt) stays
    on the device as the model's global block, independent of the corpus
    size, while gamma/Elogtheta/lzeta stream like every other family's.
    The M-step (the per-slice alpha Newtons and the betahat CG) is the
    in-memory model's (``models/dtm.make_global_update``).

    ``slice_id`` is the per-packed-row time slice ([M_pad] int, 0-based;
    rows past M are ignored); :func:`slices_from_stamps` builds it the
    reference's way (v0.6/src/DTM.jl:58-63)."""

    _api_cls = "DTM"   # the family; to_model is this class's own
    _doc_state = ("gamma", "Elogtheta", "lzeta")
    _globals = ("alpha", "betahat", "mbeta", "vbeta", "v_filt")

    def __init__(self, packed, K: int, T: int, slice_id, batch_docs: int = 8192,
                 chunk_docs: int = 1024, dtype=torch.float32, seed: int = 0,
                 state_dir: Optional[str] = None, device="cuda", mesh=None,
                 data_axis: str = "data"):
        self.T = int(T)
        slice_id = np.asarray(slice_id, np.int32)
        if slice_id.shape != (packed.M_pad,):
            raise ValueError(f"slice_id must be [M_pad]={packed.M_pad} int32 "
                             f"(got {slice_id.shape})")
        if slice_id.min() < 0 or slice_id[: packed.M].max() >= self.T:
            raise ValueError("slice_id entries must lie in [0, T).")
        self.slice_full = slice_id
        self._cgiter, self._cgtol = 20, 1.0 / self.T**2
        self._init_common(packed, K, batch_docs, chunk_docs, dtype, seed, device, state_dir,
                          mesh, data_axis)
        el0 = -sum(1.0 / i for i in range(1, self.K))   # gamma = 1
        self.gamma = self._host_full("gamma", (self.M_rows, self.K), 1.0)
        self.Elogtheta = self._host_full("Elogtheta", (self.M_rows, self.K), el0)
        self.lzeta = self._host_full("lzeta", (self.M_rows,), 1.0)

    def _init_globals(self, gen):
        # the in-memory init's draw (models/dtm.init, DTM.jl:89-118)
        T, K, V = self.T, self.K, self.V
        self.betahat = self._put(torch.randn((T, K, V), generator=gen, dtype=self.dtype))
        self.alpha = torch.ones((T, K), dtype=self.dtype, device=self.device)
        self.v_filt, self.vbeta = dtm_mod.variance_smoother(T, K, V, self.dtype, self.device)
        self.mbeta = dtm_mod.mean_smoother(self.betahat, self.v_filt)

    def _ctor_meta(self) -> dict:
        return {"T": self.T}

    def _ctor_host_arrays(self) -> dict:
        return {"slice_id": self.slice_full}

    def _data_arrays(self, sl) -> list:
        return [("slice_id", self.slice_full[self._gsl(sl)], np.int64)] + \
            super()._data_arrays(sl)

    def _chunk_plans(self, data, c) -> tuple:
        # as models/dtm.scatter_plans: token slots by slice·V + term, and
        # documents by slice
        sid = np.asarray(data["slice_id"][c]).astype(np.int64)
        flat = sid[:, None] * self.V + np.asarray(data["terms"][c])
        return (build_plan(flat, np.asarray(data["counts"][c]) > 0),
                build_plan(sid, np.asarray(data["doc_mask"][c]) > 0))

    def _compile(self, cfg) -> None:
        self._cfg = cfg
        self._gupd = dtm_mod.make_global_update(cfg.niter, cfg.ntol, self._cgiter, self._cgtol)

    def _zero_stats(self):
        z = lambda *s: torch.zeros(s, dtype=self.dtype, device=self.device)
        T, K = self.T, self.K
        return z(T * self.V, K), z(T, K), z(T, K), z(T)

    def _sweep_prep(self):
        return dtm_mod._overflow_safe(self)

    def _run_chunk(self, prep, d, c, plans, stats):
        A, wz, els, nd = stats
        K = self.K
        g2, el2, lz2, s = dtm_mod.sweep_chunk(
            prep, self.alpha, d["slice_id"][c], d["terms"][c], d["counts"][c],
            d["doc_mask"][c], d["gamma"][c], d["Elogtheta"][c], d["lzeta"][c], plans[0],
            plans[1], A, self._cfg.viter, self._cfg.vtol)
        wz.add_(s[:, :K])
        els.add_(s[:, K:2 * K])
        nd.add_(s[:, 2 * K])
        return g2, el2, lz2

    def _global_update(self, stats):
        A, wz, els, nd = stats
        self.alpha, self.betahat, self.mbeta = self._gupd(
            self.alpha, self.betahat, self.v_filt, self.vbeta, A, wz, els,
            torch.zeros_like(els), nd)

    def _elbo_tables(self):
        return dtm_mod._overflow_safe(self)

    def _elbo_chunk(self, prep, d, c):
        return (dtm_mod.elbo_chunk(prep, self.alpha, d["slice_id"][c], d["terms"][c],
                                   d["counts"][c], d["doc_mask"][c], d["gamma"][c],
                                   d["Elogtheta"][c], d["lzeta"][c]),)

    def _elbo_extra(self, prep):
        # the slice-level Elogpbeta − Elogqbeta terms, once a sweep
        return dtm_mod.slice_elbo_terms(self)

    def _finalize(self):
        self.topics = dtm_mod.topics_ranking_by_slice(self.mbeta)

    def to_model(self, runtime=None):
        raise ValueError(
            "StreamingDTM.to_model is unsupported: the api.DTM constructor derives its "
            "time slices from Corpus stamps, which a PackedCorpus does not carry.  Use "
            "save()/load() for persistence; per-slice rankings are in .topics.")

    def _set_cg(self, cgiter, cgtol) -> None:
        if cgiter <= 0:
            raise ValueError("iteration parameters must be positive integers.")
        self._cgiter = int(cgiter)
        self._cgtol = float(cgtol) if cgtol is not None else 1.0 / self.T**2

    def train(self, iter: int = 150, tol: float = 1.0, niter: int = 1000,
              ntol: Optional[float] = None, viter: int = 10, vtol: Optional[float] = None,
              cgiter: int = 20, cgtol: Optional[float] = None, checkelbo: float = 1,
              printelbo: bool = True, checkpoint_every: int = 0,
              checkpoint_dir: Optional[str] = None):
        self._set_cg(cgiter, cgtol)
        return super().train(iter=iter, tol=tol, niter=niter, ntol=ntol, viter=viter,
                             vtol=vtol, checkelbo=checkelbo, printelbo=printelbo,
                             checkpoint_every=checkpoint_every, checkpoint_dir=checkpoint_dir)

    def train_online(self, epochs: int = 1, tau0: float = 64.0, kappa: float = 0.7,
                     viter: int = 10, vtol: Optional[float] = None, niter: int = 1000,
                     ntol: Optional[float] = None, cgiter: int = 20,
                     cgtol: Optional[float] = None, checkelbo: float = 1,
                     printelbo: bool = True, shuffle_seed: int = 0,
                     checkpoint_every: int = 0, checkpoint_dir: Optional[str] = None):
        """Online SVI DTM: A/wz/els/nd are linear per-document sums, so the
        running average applies as for LDA; the CG then maximises against
        the blended statistics."""
        self._set_cg(cgiter, cgtol)
        return super().train_online(
            epochs=epochs, tau0=tau0, kappa=kappa, viter=viter, vtol=vtol, niter=niter,
            ntol=ntol, checkelbo=checkelbo, printelbo=printelbo, shuffle_seed=shuffle_seed,
            checkpoint_every=checkpoint_every, checkpoint_dir=checkpoint_dir)


_CLASSES = (StreamingLDA, StreamingCTM, StreamingFLDA, StreamingFCTM, StreamingCTPF,
            StreamingHMTM, StreamingDTM)


def _stream_cls(name):
    return {c.__name__: c for c in _CLASSES}[name]


def _ctor_extra(z, meta) -> dict:
    """Subclass constructor arguments a checkpoint carries (scalars in
    meta['ctor'], arrays as ctor_* entries)."""
    extra = dict(meta.get("ctor", {}))
    extra.update({k[5:]: z[k] for k in z.files if k.startswith("ctor_")})
    return extra


def _check_stream_meta(meta, packed, strict_corpus) -> None:
    from .checkpoint import packed_fingerprint

    if meta["format"] != _CKPT_FORMAT:
        raise ValueError(f"unsupported streaming checkpoint format {meta['format']}")
    if strict_corpus and packed_fingerprint(packed) != meta["corpus"]:
        raise ValueError("checkpoint corpus fingerprint does not match the given "
                         "packed corpus.")


def _rebuild(z, meta, packed, device):
    return _stream_cls(meta["cls"])(
        packed, meta["K"], batch_docs=meta["batch_docs"], chunk_docs=meta["chunk_docs"],
        dtype=meta["dtype"], seed=meta["seed"], device=device, **_ctor_extra(z, meta))


def load(path: str, packed, strict_corpus: bool = True, device="cuda"):
    """Rebuild a streaming model on ``device`` from a checkpoint and the
    same dense PackedCorpus, ready to continue training where it left off.

    Reads the single-file ``.npz`` of either package and the directory
    format of the multi-process runs of either package (``proc{p}.npz``
    shards of batch-strided rows, ``manifest.json`` written last), which
    resumes at any process count: on one process, or on the ranks of an
    initialised process group, each taking its own rows."""
    if os.path.isdir(path):
        mpath = os.path.join(path, "manifest.json")
        if not os.path.exists(mpath):
            raise ValueError(f"incomplete streaming checkpoint (no manifest): {path}")
        with open(mpath) as f:
            manifest = json.load(f)
        # the shard set must be exactly proc0..proc{nproc-1}: a missing
        # shard would leave its rows at their init values, a stale one
        # would scatter a dead run's rows
        expect = [os.path.join(path, f"proc{p}.npz") for p in range(int(manifest["nproc"]))]
        found = sorted(glob.glob(os.path.join(path, "proc*.npz")))
        if found != sorted(expect):
            raise ValueError(f"streaming checkpoint shard mismatch in {path}: manifest says "
                             f"nproc={manifest['nproc']} but found "
                             f"{[os.path.basename(f) for f in found]}")
        with np.load(expect[0]) as z0:
            meta = json.loads(bytes(z0["__meta__"]).decode())
            _check_stream_meta(meta, packed, strict_corpus)
            model = _rebuild(z0, meta, packed, device)
            model._restore_common(z0, meta)
        for f in expect:
            with np.load(f) as z:
                model._restore_doc_shard(z, json.loads(bytes(z["__meta__"]).decode())["row_map"])
        return model
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        _check_stream_meta(meta, packed, strict_corpus)
        model = _rebuild(z, meta, packed, device)
        model._restore_doc_shard(z, meta.get("row_map", dict(
            L=meta["batch_docs"], G=meta["batch_docs"], pid=0)))
        model._restore_common(z, meta)
    return model


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
