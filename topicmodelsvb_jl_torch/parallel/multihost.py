"""Multi-process initialisation and corpus sharding helpers.

The port of the JAX package's ``parallel/multihost.py``.  JAX runs one
program over a mesh of devices; PyTorch runs one process per device under
``torch.distributed``.  The workflow is the same on N processes:

    import topicmodelsvb_jl_torch as tt
    from topicmodelsvb_jl_torch.parallel import multihost

    multihost.initialize()            # torch.distributed handshake
    corp = tt.readcorp(...)           # every process loads the corpus
    model = tt.LDA(corp, K)           # the mesh spans every process
    model.train(...)

Every process runs the same program.  ``multihost.initialize()`` reads
``MASTER_ADDR``/``MASTER_PORT``/``RANK``/``WORLD_SIZE`` as ``torchrun``
sets them; a model built with ``mesh=None`` afterwards shards its
documents over every process, and each process keeps only its own rows
(:func:`local_rows`) of the shard-major packed corpus and of the
per-document state.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None) -> None:
    """``torch.distributed.init_process_group`` with ``torchrun``'s
    environment as the defaults.

    ``coordinator_address`` is ``host:port`` (default
    ``MASTER_ADDR:MASTER_PORT``), ``num_processes`` the world size (default
    ``WORLD_SIZE``), ``process_id`` this process's rank (default ``RANK``).
    ``backend=None`` means ``"nccl"``; ``"gloo"`` must be asked for (the
    CPU, or several processes that share one GPU, which NCCL refuses).
    With a CUDA device, the process's current device becomes
    ``LOCAL_RANK`` (default: the rank) modulo the device count.  A failed
    handshake raises; nothing falls back to another backend."""
    env = os.environ
    if coordinator_address is None:
        if "MASTER_ADDR" not in env or "MASTER_PORT" not in env:
            raise ValueError("no coordinator address: pass coordinator_address='host:port' "
                             "or set MASTER_ADDR and MASTER_PORT")
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if num_processes is None:
        if "WORLD_SIZE" not in env:
            raise ValueError("no world size: pass num_processes or set WORLD_SIZE")
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None:
        if "RANK" not in env:
            raise ValueError("no rank: pass process_id or set RANK")
        process_id = int(env["RANK"])
    backend = "nccl" if backend is None else backend
    if backend == "nccl" and not torch.cuda.is_available():
        raise RuntimeError("backend 'nccl' needs a CUDA device; pass backend='gloo' "
                           "to run on the CPU")
    if torch.cuda.is_available():
        local = int(env.get("LOCAL_RANK", process_id))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=int(num_processes), rank=int(process_id))


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    return dist.get_world_size() if is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if is_initialized() else 0


def process_doc_range(M: int) -> tuple:
    """[start, end) of the documents this process should own under the
    default contiguous document sharding (for host-side corpus IO when
    each process reads only its own shard)."""
    n, i = process_count(), process_index()
    per = -(-M // n)
    return i * per, min((i + 1) * per, M)


def local_rows(a, n_shards: int, index: int):
    """Shard ``index``'s rows of a shard-major host array (the packed
    corpus, or a whole per-document state): rows
    ``[index·n/n_shards, (index+1)·n/n_shards)``, a view.  The
    counterpart of the JAX package's ``make_global_array``: each process
    provides its own rows, and no global tensor is built."""
    n = a.shape[0]
    if n % n_shards:
        raise ValueError(f"{n} rows do not divide into {n_shards} shards")
    per = n // n_shards
    return a[index * per:(index + 1) * per]


def local_packed(packed, n_shards: int, index: int):
    """Shard ``index``'s slab of a shard-major PackedCorpus: a
    PackedCorpus of its rows alone, laid out for one shard, so a model's
    step, bound and state run on the slab unchanged.  ``order`` and
    ``inv_order`` (global packed rows) stay with the whole corpus."""
    import dataclasses

    if n_shards == 1:
        return packed
    rows = lambda a: None if a is None else np.ascontiguousarray(
        local_rows(a, n_shards, index))
    segments = None
    if packed.segments is not None:
        segments = tuple(dataclasses.replace(
            s, terms=rows(s.terms), counts=rows(s.counts), doc_mask=rows(s.doc_mask))
            for s in packed.segments)
    return dataclasses.replace(
        packed, terms=rows(packed.terms), counts=rows(packed.counts),
        doc_mask=rows(packed.doc_mask), N=rows(packed.N), C=rows(packed.C),
        readers=rows(packed.readers), ratings=rows(packed.ratings), R=rows(packed.R),
        segments=segments, order=None, inv_order=None, n_shards=1)


def local_slab(packed, mesh, doc_axes, tok_axis=None):
    """This process's slab of a dense corpus on ``mesh`` (a PackedCorpus
    or a RoutedCorpus): its block of rows over ``doc_axes`` (a name or a
    tuple of names, the first major), and with ``tok_axis`` its block of
    every row's token slot columns: the sequence axis's share of a dense
    corpus, or under routed tensor parallelism (``tok_axis`` the vocab
    axis) the slots of its vocab block.  A corpus with readers (CTPF's)
    has its reader slot columns cut alike, block ``axis_index`` of
    ``Rmax``, and ``Rmax`` becomes the block's width (the JAX package's
    ``P("data", "seq")`` on the reader arrays); the per-document ``N``,
    ``C`` and ``R`` keep whole rows.  A step, a bound and their scatter
    plans run on the slab unchanged."""
    import dataclasses

    from ..ops.packing import RoutedCorpus
    from .mesh import axis_index, axis_size

    if packed.segments is not None:
        raise ValueError("local_slab takes a dense corpus")
    n_d, i_d = axis_size(mesh, doc_axes), axis_index(mesh, doc_axes)
    n_t, i_t = axis_size(mesh, tok_axis), axis_index(mesh, tok_axis)
    if isinstance(packed, RoutedCorpus):
        if n_t not in (1, packed.n_shards):
            raise ValueError(f"a RoutedCorpus of {packed.n_shards} vocab blocks on a token "
                             f"axis of {n_t}")
        rows = lambda a: np.ascontiguousarray(local_rows(a, n_d, i_d))
        slab = dataclasses.replace(packed, terms=rows(packed.terms), counts=rows(packed.counts),
                                   doc_mask=rows(packed.doc_mask), N=rows(packed.N),
                                   C=rows(packed.C))
    else:
        slab = local_packed(packed, n_d, i_d)
    if n_t == 1:
        return slab
    if packed.L % n_t:
        raise ValueError(f"{packed.L} token slots do not divide into {n_t} shards")
    cols = lambda a, w: np.ascontiguousarray(a[:, i_t * w:(i_t + 1) * w])
    per = packed.L // n_t
    cut = dict(terms=cols(slab.terms, per), counts=cols(slab.counts, per), L=per)
    if getattr(slab, "readers", None) is not None:
        if packed.Rmax % n_t:
            raise ValueError(f"{packed.Rmax} reader slots do not divide into {n_t} shards")
        rper = packed.Rmax // n_t
        cut.update(readers=cols(slab.readers, rper), ratings=cols(slab.ratings, rper), Rmax=rper)
    return dataclasses.replace(slab, **cut)
