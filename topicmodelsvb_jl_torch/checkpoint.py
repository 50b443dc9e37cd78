"""Checkpoint and resume.

A NumPy-only copy of the JAX package's ``checkpoint.py``, in its file
format (format 2), so a checkpoint crosses between the two packages in
both directions:

* :func:`save` / :func:`load` write the full variational state plus its
  metadata (model class, K, corpus fingerprint, seed, runtime knobs, the
  global iteration counter) to one ``.npz``.  Leaves are stored as
  ``leaf_{i}`` in the order of ``meta["fields"]`` and restored by name;
  per-document leaves are stored in original document order, so a
  checkpoint restores under any chunk size.  Because the state carries
  every ``*_old`` buffer, a loaded model's ``train()`` continues the ELBO
  trace exactly.
* :func:`snapshot` / :func:`write_snapshot` / :class:`AsyncWriter` are
  the two halves of the asynchronous checkpoint: the snapshot starts the
  device-to-host copy on the training thread, the writer thread waits for
  it and writes the file.
* A model sharded over processes (``parallel/``) saves to the directory
  format of the JAX package's multi-process runs: one ``proc{i}.npz`` a
  process, its per-document leaves as (document id, value) pairs, the
  globals from process 0, and ``manifest.json`` written last, after a
  barrier.  :func:`load` reads it, and the JAX package's, at any process
  count.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import threading

import numpy as np
import torch

from .corpus import Corpus
from .ops.packing import PackedCorpus

_FORMAT_VERSION = 2   # v2: the corpus fingerprint includes Document.stamp
_MANIFEST = "manifest.json"
# knobs of the JAX package's RuntimeConfig that change nothing here; the
# mesh is the loading run's, so mesh_shape (data or tensor-parallel axes)
# loads at any world size, as the JAX package never reads it to build its
# mesh; and peak_flops is the loading device's own (a JAX checkpoint's is
# a TPU's)
_IGNORED_RUNTIME = ("use_pallas", "peak_flops", "mesh_shape")
# per-document leaves whose second axis is the packing's token width
_TOKEN_FIELDS = ("tau", "tau_old")


def packed_fingerprint(packed) -> str:
    """Stable hash of a PackedCorpus's arrays, for a model built directly
    from packed data; hash the same (pre-bucketing) object on load."""
    h = hashlib.sha256()
    for a in (packed.terms, packed.counts, packed.readers, packed.ratings):
        if a is not None:
            h.update(np.ascontiguousarray(a).tobytes())
    return "packed:" + h.hexdigest()


def corpus_fingerprint(corp: Corpus) -> str:
    """Stable hash of the corpus contents (documents, stamps, vocabulary,
    users)."""
    h = hashlib.sha256()
    for doc in corp.docs:
        h.update(np.asarray(doc.terms, np.int64).tobytes())
        h.update(np.asarray(doc.counts, np.int64).tobytes())
        h.update(np.asarray(doc.readers, np.int64).tobytes())
        h.update(np.asarray(doc.ratings, np.int64).tobytes())
        # stamps drive DTM's slices: a stamp edit with unchanged terms
        # must fail the strict fingerprint check on resume
        h.update(np.float64(np.nan if doc.stamp is None else doc.stamp).tobytes())
    for k in sorted(corp.vocab):
        h.update(f"{k}:{corp.vocab[k]};".encode())
    for k in sorted(corp.users):
        h.update(f"{k}:{corp.users[k]};".encode())
    return h.hexdigest()


def _fields(state) -> list:
    return [f.name for f in dataclasses.fields(state)]


def _model_meta(model) -> dict:
    # replay the runtime knobs that shape packing and compute on load; the
    # sinks, the profiler's directory and the checkpoint cadence belong to
    # the environment (replaying checkpoint_every without checkpoint_dir
    # would leave a resumed run silently not checkpointing), as in the JAX
    # package, whose RuntimeConfig takes every field written here
    runtime = {k: v for k, v in dataclasses.asdict(model.runtime).items()
               if k not in ("metrics_path", "profile_dir", "checkpoint_dir",
                            "checkpoint_every")
               and v is not None}
    fields = _fields(model.state)
    return dict(
        format=_FORMAT_VERSION,
        model=type(model).__name__,
        K=model.K,
        seed=model.seed,
        dtype=str(model.dtype).replace("torch.", ""),
        runtime=runtime,
        # for a packed-built model: the pre-bucketing object the user holds
        corpus=model._fingerprint,
        n_leaves=len(fields),
        fields=fields,
        doc_fields=sorted(model._per_doc_fields),
        ctor=model._ctor_kwargs(),
        trained=model.topics is not None,
        # the global outer-iteration counter: a resumed run continues k,
        # its JSONL rows and its ckpt_iter* names
        iteration=int(model.trained_iters),
    )


def save(path: str, model, compress: str = None) -> None:
    """Save a model's state and metadata to the file ``path``; for a model
    sharded over processes, to the directory ``path`` (call it on every
    process: it waits for all of them).

    ``compress="f16"`` halves the bytes of the per-document leaves (see
    :func:`snapshot`)."""
    if model._n_shards > 1:
        _save_multihost(path, model, compress=compress)
        return
    write_snapshot(path, snapshot(model, compress=compress))


def _row_to_doc(model) -> np.ndarray:
    """Packed state row → original 0-based document id (−1 for padding)."""
    row2doc = np.full(model.packed.M_pad, -1, dtype=np.int64)
    row2doc[model._doc_rows()] = np.arange(model.M, dtype=np.int64)
    return row2doc


def _save_multihost(path: str, model, compress: str = None) -> None:
    """Directory checkpoint of a model sharded over processes, as the JAX
    package's ``_save_multihost`` writes it: every process writes
    ``proc{i}.npz`` with the documents of its rows as (id, value) pairs,
    process 0 adds the globals (the same on every process) and, after a
    barrier, ``manifest.json``, so a manifest certifies a whole
    checkpoint."""
    from .parallel.shard import barrier

    if compress not in (None, "f16"):
        raise ValueError(f"unknown checkpoint compression {compress!r}")
    pid = model._shard
    # the replicas of a slab over a mesh's other axes hold the same rows:
    # the first writes them
    writes = model._replica == 0
    fields = _fields(model.state)
    doc_fields = set(model._per_doc_fields)
    row2doc = _row_to_doc(model)
    arrays = {}
    for i, name in enumerate(fields):
        x = getattr(model.state, name).detach().cpu().numpy()
        if name in doc_fields:
            ids = row2doc[model._row_lo:model._row_lo + x.shape[0]]
            keep = ids >= 0
            vals = x[keep]
            if (compress == "f16" and np.issubdtype(vals.dtype, np.floating) and vals.size
                    and np.max(np.abs(vals)) < 65504.0):
                vals = vals.astype(np.float16)   # snapshot()'s range guard
            arrays[f"leaf_{i}_ids"] = ids[keep]
            arrays[f"leaf_{i}"] = vals
        elif pid == 0:
            arrays[f"leaf_{i}"] = x
    if writes:
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, f"proc{pid}.npz"), "wb") as f:
            np.savez(f, **arrays)
    barrier(model.mesh)
    if pid == 0 and writes:
        manifest = dict(meta=_model_meta(model), n_procs=model._n_shards)
        tmp = os.path.join(path, _MANIFEST + ".tmp")
        with open(tmp, "w") as f:
            json.dump(manifest, f)
        os.replace(tmp, os.path.join(path, _MANIFEST))
    barrier(model.mesh)


def snapshot(model, compress: str = None) -> tuple:
    """Capture ``(meta, leaves, doc_fields, rows, event)``: everything
    :func:`write_snapshot` needs, taken on the training thread.

    The device-to-host copy of every leaf starts here, into pinned host
    buffers, and ``event`` (None off CUDA) marks its end on the stream;
    the writer waits on it, so this call does not wait for the device.
    CPU leaves are cloned, so training may go on while the writer runs.

    ``compress="f16"`` casts the per-document leaves, the snapshot's
    dominant bytes, to float16 on the device before the copy.  A leaf
    with an entry beyond the f16 range (gamma of a document of more than
    65,504 tokens), or a NaN, stays at full precision.  A resume from the
    rounded state re-converges rather than reproducing the trace.
    Globals are never compressed."""
    state = model.state
    meta = _model_meta(model)
    doc_fields = set(model._per_doc_fields)
    leaves = {n: getattr(state, n) for n in meta["fields"]}
    if compress == "f16":
        meta["compress"] = "f16"
        for n in doc_fields:
            x = leaves[n]
            if x.is_floating_point() and float(x.abs().max()) < 65504.0:
                leaves[n] = x.to(torch.float16)
    elif compress is not None:
        raise ValueError(f"unknown checkpoint compression {compress!r}")
    event = None
    host = {}
    for n, x in leaves.items():
        if x.device.type == "cuda":
            host[n] = x.detach().to("cpu", non_blocking=True)
            if event is None:
                event = torch.cuda.Event()
        else:
            host[n] = x.detach().clone()
    if event is not None:
        event.record()
    return meta, host, doc_fields, model._doc_rows(), event


def write_snapshot(path: str, snap: tuple) -> None:
    """Wait for a :func:`snapshot`'s copies and write it to ``path``."""
    meta, leaves, doc_fields, rows, event = snap
    if event is not None:
        event.synchronize()
    arrays = {}
    for i, name in enumerate(meta["fields"]):
        arr = leaves[name].numpy()
        if name in doc_fields:
            arr = arr[rows]              # packed rows → original document order
        arrays[f"leaf_{i}"] = arr
    # through a file handle: np.savez appends '.npz' to a bare path
    with open(path, "wb") as f:
        np.savez(f, __meta__=np.frombuffer(json.dumps(meta).encode(), np.uint8), **arrays)


class AsyncWriter:
    """One-slot background writer: ``submit(fn)`` runs ``fn`` on a daemon
    thread; a second submit (or ``wait``) first joins the write in
    flight, so at most one checkpoint is in flight.  An error of the
    thread is raised by the next submit or wait."""

    def __init__(self):
        self._thread = None
        self._exc = None

    def submit(self, fn) -> None:
        self.wait()

        def run():
            try:
                fn()
            except BaseException as e:   # raised again on the caller's thread
                self._exc = e

        self._thread = threading.Thread(target=run, name="tmvb-ckpt-writer", daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._exc is not None:
            exc, self._exc = self._exc, None
            raise exc


def _runtime(meta: dict, cls):
    """The RuntimeConfig a checkpoint replays.  The JAX package's knobs
    that change nothing here are skipped; an unknown one raises."""
    from .utils.config import RuntimeConfig

    if "runtime" not in meta:   # older checkpoints: dtype and the class's chunk
        return RuntimeConfig(dtype=meta["dtype"], chunk_docs=cls._preferred_chunk)
    known = {f.name for f in dataclasses.fields(RuntimeConfig)}
    kw = {}
    for k, v in meta["runtime"].items():
        if k in _IGNORED_RUNTIME:
            continue
        if k in known:
            kw[k] = v
        else:
            raise ValueError(f"unknown runtime knob {k!r} in the checkpoint")
    return RuntimeConfig(**kw)


def _rebuild_model(meta: dict, corp, strict_corpus: bool, device, mesh=None):
    from . import api

    if meta["format"] != _FORMAT_VERSION:
        raise ValueError(f"unsupported checkpoint format {meta['format']} "
                         f"(this build reads format {_FORMAT_VERSION}).")
    fp = (packed_fingerprint(corp) if isinstance(corp, PackedCorpus)
          else corpus_fingerprint(corp))
    if strict_corpus and fp != meta["corpus"]:
        raise ValueError("checkpoint corpus fingerprint does not match the given corpus.")
    cls = getattr(api, meta["model"], None)
    if not (isinstance(cls, type) and issubclass(cls, api.TopicModel)):
        raise ValueError(f"checkpoint of a {meta['model']} model, which this package "
                         "does not have")
    rt = _runtime(meta, cls)
    # the constructor asks the dtype gate first (kernels._build.check_dtype:
    # float32 and float64 load on either device)
    model = cls(corp, meta["K"], runtime=rt, mesh=mesh, device=device, seed=meta["seed"],
                **meta.get("ctor", {}))
    model._fingerprint_cache = fp   # the same contents the model would hash
    model.trained_iters = int(meta.get("iteration", 0))
    return model


def _restore_state(model, meta: dict, global_leaves: dict, doc_chunks: dict) -> None:
    """Install checkpointed leaves into a freshly built model, by name.

    ``global_leaves[name]`` is the full array; ``doc_chunks[name]`` a list
    of (doc_ids, values) pairs whose union covers documents 0..M-1,
    scattered into this model's packed rows (padding rows keep their init
    values): on a model sharded over processes, the rows of this process.  The token-width axis of ``tau``/``tau_old`` follows the
    packing: columns past the narrower width are padding slots."""
    names = _fields(model.state)
    if sorted(names) != sorted(meta["fields"]):
        raise ValueError(f"checkpoint fields {meta['fields']} do not match the "
                         f"{type(model).__name__} state's {names}")
    doc_fields = set(meta.get("doc_fields", []))
    rows = model._doc_rows()
    lo = model._row_lo
    fixed = {}
    for name in names:
        ref = getattr(model.state, name)
        out = ref.detach().cpu().numpy().copy()
        if name in doc_fields:
            covered = 0
            for ids, vals in doc_chunks[name]:
                vals = np.asarray(vals)
                r = rows[ids] - lo
                mine = (r >= 0) & (r < out.shape[0])
                if vals.shape[1:] == out.shape[1:]:
                    out[r[mine]] = vals[mine]
                elif name in _TOKEN_FIELDS and vals.ndim == out.ndim == 2:
                    w = min(vals.shape[1], out.shape[1])
                    out[r[mine], :w] = vals[mine, :w]
                else:
                    raise ValueError(f"checkpoint field {name} row shape {vals.shape[1:]} "
                                     f"incompatible with {out.shape[1:]}")
                covered += len(ids)
            if covered < model.M:
                raise ValueError(f"checkpoint field {name} covers {covered} of "
                                 f"{model.M} documents")
        else:
            saved = np.asarray(global_leaves[name])
            if name == "elbo" and saved.shape == () and out.shape == (2,):
                # pre-compensation checkpoint: scalar bound → (hi, lo=0)
                saved = np.stack([saved, np.zeros_like(saved)])
            if saved.shape != out.shape:
                raise ValueError(f"checkpoint field {name} shape {saved.shape} != {out.shape}")
            out = saved
        fixed[name] = torch.as_tensor(np.array(out), dtype=ref.dtype).to(ref.device)
    model.state = type(model.state)(**fixed)
    # derived artifacts (rankings, scores) for a trained checkpoint only:
    # an untrained model's recs stay unranked
    if meta.get("trained", True):
        model._finalize()


def load(path: str, corp, strict_corpus: bool = True, device="cuda", mesh=None):
    """Rebuild the model of a checkpoint on ``device`` from the corpus it
    was trained on.

    ``strict_corpus=True`` checks the corpus fingerprint, so a resumed run
    trains on the data it left off with.  Reads the single-file format and
    the multi-process directory format, whatever the process count that
    wrote it; ``mesh`` is the model's (see ``api.TopicModel``), so under an
    initialised process group every process loads its own rows."""
    if os.path.isdir(path):
        return _load_multihost(path, corp, strict_corpus, device, mesh)
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        leaves = [z[f"leaf_{i}"] for i in range(meta["n_leaves"])]
    model = _rebuild_model(meta, corp, strict_corpus, device, mesh)
    all_ids = np.arange(model.M, dtype=np.int64)
    doc_fields = set(meta.get("doc_fields", []))
    global_leaves, doc_chunks = {}, {}
    for name, saved in zip(meta["fields"], leaves):
        if name in doc_fields:
            if saved.shape[0] != model.M:
                raise ValueError(f"checkpoint field {name} has {saved.shape[0]} rows "
                                 f"for {model.M} documents")
            doc_chunks[name] = [(all_ids, saved)]
        else:
            global_leaves[name] = saved
    _restore_state(model, meta, global_leaves, doc_chunks)
    return model


def _load_multihost(path: str, corp, strict_corpus: bool, device, mesh=None):
    """Load a directory checkpoint: ``manifest.json`` and one
    ``proc{i}.npz`` a process, whose per-document leaves come with their
    document ids (``leaf_{i}_ids``); the globals are process 0's."""
    with open(os.path.join(path, _MANIFEST)) as f:
        manifest = json.load(f)
    meta = manifest["meta"]
    model = _rebuild_model(meta, corp, strict_corpus, device, mesh)
    doc_fields = set(meta.get("doc_fields", []))
    global_leaves = {}
    doc_chunks = {name: [] for name in doc_fields}
    for p in range(manifest["n_procs"]):
        with np.load(os.path.join(path, f"proc{p}.npz")) as z:
            for i, name in enumerate(meta["fields"]):
                if name in doc_fields:
                    doc_chunks[name].append((z[f"leaf_{i}_ids"], z[f"leaf_{i}"]))
                elif p == 0:
                    global_leaves[name] = z[f"leaf_{i}"]
    # processes may overlap (each wrote every document); the scatter is
    # idempotent, and coverage counts unique ids
    for name in doc_fields:
        seen = (np.concatenate([ids for ids, _ in doc_chunks[name]])
                if doc_chunks[name] else np.zeros((0,), np.int64))
        n = len(np.unique(seen))
        if n < model.M:
            raise ValueError(f"checkpoint field {name} covers {n} of {model.M} documents")
    _restore_state(model, meta, global_leaves, doc_chunks)
    return model
