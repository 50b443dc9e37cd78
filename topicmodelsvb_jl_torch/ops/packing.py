"""Ragged→dense corpus packing (host NumPy).

Documents are packed into dense ``[M_pad, L]`` blocks with zero-count
padding; raggedness is handled by masking — padded slots carry
``count = 0`` so they contribute exactly nothing to any statistic or
ELBO term.  Under length bucketing, docs are length-sorted and grouped
into equal-width segments so token-axis work runs at each segment's own
width.

This is a copy of the NumPy-only part of the JAX package's
``ops/packing.py``: importing any submodule of that package first runs
its ``__init__``, which imports JAX.  ``tests/test_torch_lda.py`` holds
both copies to byte-identical output.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


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
