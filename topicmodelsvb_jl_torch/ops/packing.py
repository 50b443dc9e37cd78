"""Ragged→dense corpus packing (host NumPy).

Documents are packed into dense ``[M_pad, L]`` blocks with zero-count
padding; raggedness is handled by masking — padded slots carry
``count = 0`` so they contribute exactly nothing to any statistic or
ELBO term.  Under length bucketing, docs are length-sorted and grouped
into equal-width segments so token-axis work runs at each segment's own
width.

This is a copy of the NumPy-only part of the JAX package's
``ops/packing.py`` (``pack_corpus`` without its native C++ fill, and
the disk-backed ``save_packed``/``load_packed``/``trim_packed`` that the
streaming models read, and ``route_packed`` with its ``RoutedCorpus``
for routed tensor parallelism):
importing any submodule of that package first runs its ``__init__``,
which imports JAX.  ``tests/test_torch_lda.py`` and
``tests/test_torch_ctpf.py`` hold both copies to byte-identical output.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..corpus import Corpus


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m if x > 0 else m


@dataclasses.dataclass(frozen=True)
class PackedCorpus:
    """Dense corpus arrays (host NumPy; the model moves them to its device).

    ``terms``/``readers`` are **0-based** (reference keys are 1-based);
    padded slots point at id 0 with zero count/rating, so scatters into
    row 0 add zeros.
    """

    terms: np.ndarray        # [M_pad, L] int32, 0-based vocab ids
    counts: np.ndarray       # [M_pad, L] float, 0 on padding
    doc_mask: np.ndarray     # [M_pad] float, 1 for real docs
    N: np.ndarray            # [M_pad] int32  unique-term counts
    C: np.ndarray            # [M_pad] float  Σcounts per doc
    M: int                   # number of real documents
    V: int
    L: int
    readers: Optional[np.ndarray] = None   # [M_pad, R] int32, 0-based user ids
    ratings: Optional[np.ndarray] = None   # [M_pad, R] float, 0 on padding
    R: Optional[np.ndarray] = None         # [M_pad] int32 reader counts
    U: int = 0
    Rmax: int = 0
    max_count: int = 0       # max single term count
    max_rating: int = 0

    # ── optional length-bucketed layout ──
    # When set, token-axis work runs per segment at that segment's own
    # padded width instead of the corpus-global L (docs are length-
    # sorted, dealt into equal chunks per shard, and consecutive
    # equal-width chunk groups form segments).  ``order``/``inv_order``
    # map packed row ↔ original document index.
    segments: Optional[tuple] = None       # tuple[Segment]
    order: Optional[np.ndarray] = None     # [M_pad] packed row → orig doc (-1 pad)
    inv_order: Optional[np.ndarray] = None # [M] orig doc → packed row
    n_shards: int = 1
    chunk: int = 0                         # docs per chunk per shard

    @property
    def M_pad(self) -> int:
        return self.terms.shape[0]


def pack_corpus(
    corp: Corpus,
    pad_multiple: int = 64,
    docs_multiple: int = 8,
    with_readers: bool = False,
    dtype=np.float32,
) -> PackedCorpus:
    """Pack a checked corpus into dense padded arrays.

    ``pad_multiple`` rounds the token axis L; ``docs_multiple`` rounds the
    doc axis.  With ``with_readers`` the reader arrays (readers, ratings,
    R, U, Rmax) are packed too, for CTPF.
    """
    M, V, U = corp.shape
    N = np.array([len(doc) for doc in corp.docs], dtype=np.int32)
    L = _round_up(int(N.max()) if M else 1, pad_multiple)
    M_pad = _round_up(max(M, 1), docs_multiple)

    terms = np.zeros((M_pad, L), dtype=np.int32)
    counts = np.zeros((M_pad, L), dtype=dtype)
    for d, doc in enumerate(corp.docs):
        n = len(doc.terms)
        if n:
            terms[d, :n] = np.asarray(doc.terms, dtype=np.int64) - 1
            counts[d, :n] = doc.counts

    doc_mask = np.zeros(M_pad, dtype=dtype)
    doc_mask[:M] = 1.0
    N_full = np.zeros(M_pad, dtype=np.int32)
    N_full[:M] = N
    C = counts.sum(axis=1).astype(dtype)
    max_count = int(counts.max()) if M else 0

    kw = {}
    Rmax = 0
    max_rating = 0
    if with_readers:
        Rv = np.array([len(doc.readers) for doc in corp.docs], dtype=np.int32)
        Rmax = _round_up(int(Rv.max()) if M and Rv.size and Rv.max() > 0 else 1, 8)
        readers = np.zeros((M_pad, Rmax), dtype=np.int32)
        ratings = np.zeros((M_pad, Rmax), dtype=dtype)
        for d, doc in enumerate(corp.docs):
            r = len(doc.readers)
            if r:
                readers[d, :r] = np.asarray(doc.readers, dtype=np.int64) - 1
                ratings[d, :r] = doc.ratings
        R_full = np.zeros(M_pad, dtype=np.int32)
        R_full[:M] = Rv
        max_rating = int(ratings.max()) if M else 0
        kw = dict(readers=readers, ratings=ratings, R=R_full, U=U, Rmax=Rmax)

    return PackedCorpus(
        terms=terms, counts=counts, doc_mask=doc_mask, N=N_full, C=C,
        M=M, V=V, L=L, max_count=max_count, max_rating=max_rating, **kw
    )


@dataclasses.dataclass(frozen=True)
class Segment:
    """One equal-width slice of a bucketed corpus.

    Rows are **shard-major**: shard ``s`` of ``n_shards`` owns rows
    ``[s·n_local, (s+1)·n_local)``.  ``loc_start`` is the segment's row
    offset inside each shard's slice of the doc-major state arrays
    (gamma/Elogtheta/…).
    """

    terms: np.ndarray      # [n_shards · n_local, L]
    counts: np.ndarray     # [n_shards · n_local, L]
    doc_mask: np.ndarray   # [n_shards · n_local]
    L: int
    n_local: int           # rows per shard (multiple of chunk)
    loc_start: int         # row offset within each shard's local state


def bucketize(
    terms: np.ndarray,     # [M_pad, L_max] packed (padding rows allowed)
    counts: np.ndarray,
    N: np.ndarray,         # [M_pad] real token counts (0 for padding rows)
    doc_mask: np.ndarray,
    chunk: int,
    n_shards: int = 1,
    pad_multiple: int = 32,
):
    """Length-sort + shard-deal + equal-width segment grouping.

    Returns (segments, order, local_size): ``order[packed_row]`` is the
    source row each packed row came from.  The total padded doc count is
    rounded up to ``chunk·n_shards``; appended padding rows map to -1.
    """
    M_src = terms.shape[0]
    block = chunk * n_shards
    M_pad = _round_up(max(M_src, 1), block)

    # longest-first so early blocks get the wide segments
    src_order = np.argsort(-N[:M_src], kind="stable").astype(np.int64)
    order = np.full(M_pad, -1, dtype=np.int64)
    order[:M_src] = src_order

    n_blocks = M_pad // block
    local_size = n_blocks * chunk

    # per-block padded width
    blk_L = np.zeros(n_blocks, dtype=np.int64)
    for b in range(n_blocks):
        sel = order[b * block : (b + 1) * block]
        real = sel[sel >= 0]
        mx = int(N[real].max()) if real.size else 0
        blk_L[b] = _round_up(max(mx, 1), pad_multiple)

    segments = []
    b0 = 0
    while b0 < n_blocks:
        b1 = b0
        while b1 < n_blocks and blk_L[b1] == blk_L[b0]:
            b1 += 1
        L = int(blk_L[b0])
        nb = b1 - b0
        # rows for this segment, shard-major: [n_shards, nb, chunk]
        sel = order[b0 * block : b1 * block].reshape(nb, n_shards, chunk)
        rows = np.ascontiguousarray(sel.transpose(1, 0, 2)).reshape(-1)
        ok = rows >= 0
        safe = np.where(ok, rows, 0)
        Lc = min(L, terms.shape[1])
        seg_t = np.zeros((rows.shape[0], L), dtype=terms.dtype)
        seg_c = np.zeros((rows.shape[0], L), dtype=counts.dtype)
        seg_t[:, :Lc] = np.where(ok[:, None], terms[safe, :Lc], 0)
        seg_c[:, :Lc] = np.where(ok[:, None], counts[safe, :Lc], 0)
        seg_m = np.where(ok, doc_mask[safe], 0).astype(doc_mask.dtype)
        segments.append(Segment(
            terms=seg_t, counts=seg_c, doc_mask=seg_m, L=L,
            n_local=nb * chunk, loc_start=b0 * chunk,
        ))
        b0 = b1

    return tuple(segments), order, local_size


def seg_loc_starts(packed):
    """Per-segment ``loc_start`` tuple, or None for dense layouts."""
    if packed.segments is None:
        return None
    return tuple(int(s.loc_start) for s in packed.segments)


def bucketize_packed(
    packed: PackedCorpus,
    chunk: int,
    n_shards: int = 1,
    pad_multiple: int = 32,
) -> PackedCorpus:
    """Return a bucketed copy of a dense PackedCorpus.

    The dense doc-major fields (terms/counts/doc_mask/N/C and the
    reader arrays) are re-ordered into the packed (length-sorted,
    shard-major) row order so per-doc state arrays line up with the
    segments; ``inv_order`` maps original doc index → packed row.
    """
    segments, order, local_size = bucketize(
        packed.terms, packed.counts, packed.N, packed.doc_mask,
        chunk=chunk, n_shards=n_shards, pad_multiple=pad_multiple,
    )
    M_pad = n_shards * local_size

    # packed row for (block b, shard s, slot j) holds order[b·block + s·chunk + j]
    n_blocks = local_size // chunk
    # rows in packed order: transpose [nb, n_shards, chunk] → shard-major
    rows_pk = np.ascontiguousarray(
        order.reshape(n_blocks, n_shards, chunk).transpose(1, 0, 2)
    ).reshape(-1)                           # [M_pad] source row per packed row
    ok_pk = rows_pk >= 0
    safe_pk = np.where(ok_pk, rows_pk, 0)

    def reorder(a, fill=0):
        if a is None:
            return None
        out = np.full((M_pad,) + a.shape[1:], fill, dtype=a.dtype)
        sel = a[safe_pk]
        mask = ok_pk.reshape((-1,) + (1,) * (a.ndim - 1))
        out[:] = np.where(mask, sel, fill)
        return out

    inv_order = np.zeros(max(packed.M, 1), dtype=np.int64)
    valid = ok_pk & (rows_pk < packed.M)
    inv_order[rows_pk[valid]] = np.nonzero(valid)[0]

    return dataclasses.replace(
        packed,
        terms=reorder(packed.terms), counts=reorder(packed.counts),
        doc_mask=reorder(packed.doc_mask), N=reorder(packed.N),
        C=reorder(packed.C),
        readers=reorder(packed.readers), ratings=reorder(packed.ratings),
        R=reorder(packed.R),
        segments=segments, order=order, inv_order=inv_order,
        n_shards=n_shards, chunk=chunk,
    )


def unit_counts(packed: PackedCorpus) -> PackedCorpus:
    """Copy of ``packed`` with every real term count set to 1 (padding
    stays 0), on dense and bucketed layouts, with ``C`` and ``max_count``
    recomputed.  It discards multiplicity, so it is not the
    order-preserving expansion HMTM needs for real data (that is
    ``corpus.expand_corp``, applied before packing); it turns synthetic
    packed corpora, whose counts carry no order, into HMTM's input."""
    def unit(c):
        return (c > 0).astype(c.dtype)

    counts = unit(packed.counts)
    segments = packed.segments
    if segments is not None:
        segments = tuple(dataclasses.replace(s, counts=unit(s.counts)) for s in segments)
    return dataclasses.replace(
        packed, counts=counts, C=counts.sum(axis=1),
        max_count=int(counts.max()) if counts.size else 0, segments=segments)


# ── disk-backed packed corpora (reference todo.txt:6, "stream docs from
# disk").  A PackedCorpus saved with save_packed loads back as read-only
# np.memmap views: a batch slice touches only its own pages, so the
# streaming models train corpora larger than host RAM.  Dense layouts
# only: bucketing permutes rows in memory.  The directory format is the
# JAX package's, byte for byte. ──

_PACKED_ARRAYS = ("terms", "counts", "doc_mask", "N", "C", "readers", "ratings", "R")
_PACKED_SCALARS = ("M", "V", "L", "U", "Rmax", "max_count", "max_rating")


@dataclasses.dataclass(frozen=True)
class RoutedCorpus:
    """Token slots routed to the vocab shard that OWNS them (routed TP).

    Column layout: ``terms[:, s*Ls:(s+1)*Ls]`` holds the slots whose
    global vocab id falls in shard ``s``'s contiguous block
    ``[s*Vs, (s+1)*Vs)`` — stored as SHARD-LOCAL ids (``global − s·Vs``)
    so the device code gathers/scatters straight into its local
    ``[Vs, K]`` beta shard with no offset arithmetic.  Sharding the
    column axis over the vocab mesh axis (``P(data, vocab)``) therefore
    gives every device exactly the tokens its beta shard can serve:
    the E-step's gather table, stat scatter, and M-step normalize all
    become O(V/n) per device (see models/lda.py make_step
    ``vocab_routed``).  Padding slots are local id 0 / count 0.
    """

    terms: np.ndarray       # [M_pad, n_shards·Ls] int32, shard-local ids
    counts: np.ndarray      # [M_pad, n_shards·Ls] float, 0 on padding
    doc_mask: np.ndarray    # [M_pad]
    N: np.ndarray           # [M_pad] unique-term counts (unchanged)
    C: np.ndarray           # [M_pad] Σcounts per doc (unchanged)
    M: int
    V: int                  # GLOBAL vocabulary size
    Vs: int                 # per-shard vocab block = V // n_shards
    n_shards: int
    Ls: int                 # slot width per shard block
    L: int                  # = n_shards · Ls
    fill: float = 0.0       # real slots / (M·n_shards·Ls) — balance figure

    # dense layout markers (seg_loc_starts → None; no reader arrays)
    segments = None
    readers = None
    ratings = None
    R = None
    U = 0

    @property
    def M_pad(self) -> int:
        return self.terms.shape[0]


def route_packed(packed: PackedCorpus, n_shards: int,
                 pad_multiple: int = 8) -> RoutedCorpus:
    """Re-lay a dense PackedCorpus so each document's token slots are
    grouped by the vocab shard that owns their id (routed tensor
    parallelism — the design that divides the E-step's per-device O(V)
    WORK by the shard count, where plain ``vocab_axis`` TP only divides
    beta *storage* and all-gathers it back; RESULTS.md "when vocab-TP
    pays").  Shard ``s`` owns the contiguous global-id block
    ``[s·Vs, (s+1)·Vs)``, matching beta's ``P(None, vocab)`` storage
    sharding, so no id permutation leaks into the model state.

    ``Ls`` (the per-shard slot width) is the max per-document
    per-shard slot count rounded up to ``pad_multiple``; vocab-block
    load imbalance shows up as padding, reported in ``.fill``.
    """
    if packed.segments is not None:
        raise ValueError("route_packed takes a dense (non-bucketed) "
                         "PackedCorpus; route before bucketizing.")
    if n_shards <= 0 or packed.V % n_shards:
        raise ValueError(
            f"V={packed.V} must divide evenly into n_shards={n_shards} "
            f"vocab blocks (trim or pad the vocabulary first).")
    S = int(n_shards)
    Vs = packed.V // S
    terms = np.asarray(packed.terms)
    counts = np.asarray(packed.counts)
    M_pad, L = terms.shape
    valid = counts > 0
    # padding slots sort to a virtual shard S (past every real block)
    shard = np.where(valid, terms // Vs, S).astype(np.int32)
    order = np.argsort(shard, axis=1, kind="stable")
    s_sorted = np.take_along_axis(shard, order, 1)
    t_sorted = np.take_along_axis(terms, order, 1)
    c_sorted = np.take_along_axis(counts, order, 1)
    # per-row per-shard slot counts and exclusive prefix starts
    cnt = np.stack([(shard == s).sum(1) for s in range(S)], axis=1)
    Ls = _round_up(int(cnt.max()) if M_pad else 0, pad_multiple)
    starts = np.concatenate(
        [np.zeros((M_pad, 1), np.int64), np.cumsum(cnt, 1)], axis=1)
    j = np.arange(L, dtype=np.int64)[None, :]
    real = s_sorted < S
    s_idx = np.where(real, s_sorted, 0).astype(np.int64)
    within = j - np.take_along_axis(starts, s_idx, 1)
    dest = s_idx * Ls + within
    rows = np.broadcast_to(np.arange(M_pad)[:, None], (M_pad, L))
    out_t = np.zeros((M_pad, S * Ls), dtype=terms.dtype)
    out_c = np.zeros((M_pad, S * Ls), dtype=counts.dtype)
    out_t[rows[real], dest[real]] = (t_sorted[real]
                                     - s_idx[real] * Vs).astype(terms.dtype)
    out_c[rows[real], dest[real]] = c_sorted[real]
    denom = max(1, packed.M * S * Ls)
    return RoutedCorpus(
        terms=out_t, counts=out_c,
        doc_mask=np.asarray(packed.doc_mask).copy(),
        N=np.asarray(packed.N).copy(), C=np.asarray(packed.C).copy(),
        M=packed.M, V=packed.V, Vs=Vs, n_shards=S, Ls=Ls, L=S * Ls,
        fill=float(valid.sum()) / denom,
    )


def _refuse_routed(packed, what: str) -> None:
    if isinstance(packed, RoutedCorpus):
        raise ValueError(f"{what} takes a PackedCorpus, not a RoutedCorpus: apply it to "
                         "the dense corpus, then route_packed the result")


def trim_packed(packed: PackedCorpus, chunk_rows: int = 65536, users: bool = False) -> tuple:
    """Drop the vocabulary ids no document uses: the PackedCorpus analogue
    of ``fixcorp(corp, trim=True)`` (reference trimcorp!,
    Corpus.jl:520-529) for corpora that never existed as a ``Corpus``.

    Returns ``(trimmed, used_ids)``: ``trimmed.terms`` are re-keyed densely
    to ``[0, len(used_ids))`` and ``used_ids`` maps new → old id, so a
    trained topic matrix expands back with ``beta_full[:, used_ids] =
    beta_trim``.  ``terms`` is scanned ``chunk_rows`` rows at a time, so a
    memmapped corpus trims without being read whole (the outputs are in
    RAM).  Padding slots stay id 0 / count 0.  ``users=True`` trims the
    reader axis the same way (reference trimcorp!, Corpus.jl:647-651) and
    returns ``(trimmed, used_ids, used_users)``."""
    _refuse_routed(packed, "trim_packed")

    def trim_axis(ids, weights, n):
        present = np.zeros(n, dtype=bool)
        for lo in range(0, packed.M_pad, chunk_rows):
            i = np.asarray(ids[lo:lo + chunk_rows])
            w = np.asarray(weights[lo:lo + chunk_rows])
            present[i[w > 0]] = True
        used = np.flatnonzero(present).astype(np.int64)
        remap = np.zeros(n, dtype=np.int32)    # padding id 0 → 0
        remap[used] = np.arange(len(used), dtype=np.int32)
        out = np.empty_like(np.asarray(ids))
        for lo in range(0, packed.M_pad, chunk_rows):
            i = np.asarray(ids[lo:lo + chunk_rows])
            w = np.asarray(weights[lo:lo + chunk_rows])
            ni = remap[i]
            ni[w <= 0] = 0
            out[lo:lo + chunk_rows] = ni
        return out, used

    new_terms, used_ids = trim_axis(packed.terms, packed.counts, packed.V)
    repl = dict(terms=new_terms, V=int(len(used_ids)))
    if users:
        if packed.readers is None:
            raise ValueError("users=True needs a packed corpus with "
                             "reader arrays (pack_corpus with_readers)")
        new_readers, used_users = trim_axis(packed.readers, packed.ratings, packed.U)
        repl.update(readers=new_readers, U=int(len(used_users)))
        return dataclasses.replace(packed, **repl), used_ids, used_users
    return dataclasses.replace(packed, **repl), used_ids


def save_packed(path: str, packed: PackedCorpus) -> None:
    """Write a dense PackedCorpus as ``<path>/meta.json`` and one ``.npy``
    per array (uncompressed, so it loads as a memory map)."""
    import json
    import os

    _refuse_routed(packed, "save_packed")
    if packed.segments is not None:
        raise ValueError("save_packed takes a dense (non-bucketed) "
                         "PackedCorpus; save before bucketizing.")
    os.makedirs(path, exist_ok=True)
    present = []
    for name in _PACKED_ARRAYS:
        a = getattr(packed, name)
        if a is not None:
            np.save(os.path.join(path, f"{name}.npy"), np.ascontiguousarray(a))
            present.append(name)
    meta = {s: int(getattr(packed, s)) for s in _PACKED_SCALARS}
    meta["arrays"] = present
    meta["counts_dtype"] = str(packed.counts.dtype)
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f)


def load_packed(path: str, mmap: bool = True) -> PackedCorpus:
    """Load a :func:`save_packed` directory.  With ``mmap=True`` (the
    default) every array is a read-only memory map: building the corpus
    costs no corpus-sized RAM, and a streamed batch reads only its pages."""
    import json
    import os

    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    kw = {s: meta[s] for s in _PACKED_SCALARS}
    for name in meta["arrays"]:
        kw[name] = np.load(os.path.join(path, f"{name}.npy"), mmap_mode="r" if mmap else None)
    return PackedCorpus(**kw)
