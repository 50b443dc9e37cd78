"""Synthetic corpus generators.

The reference ships the NSF abstracts corpus (128,804 docs / 25,319
vocab, README.md:34-41) through ``readcorp(:nsf)``.  The docfile is not
bundled here, so the benchmark input is a seeded synthetic corpus at that
scale, packed directly.  This is a copy of the JAX package's
``datasets.synth_packed_nsf_scale``; ``tests/test_torch_lda.py`` holds the
two to byte-identical arrays for the same seed.
"""

from __future__ import annotations

import numpy as np

from .ops.packing import PackedCorpus, _round_up


def synth_packed_nsf_scale(M=128_804, V=25_319, mean_terms=85, seed=7,
                           chunk_docs=1024, pad_multiple=32,
                           dtype=np.float32, skew: float = 3.0):
    """Vectorised synthetic corpus at NSF scale, packed directly.

    Zipf-like vocab draw (u^skew skews mass to low ids), Poisson doc
    lengths clipped at 8 terms, seed-controlled; returns a dense
    PackedCorpus suitable for ``LDA(packed, K)`` or bucketize_packed."""
    rng = np.random.default_rng(seed)
    N = np.clip(rng.poisson(mean_terms, size=M), 8, None).astype(np.int32)
    L = _round_up(int(N.max()), pad_multiple)
    M_pad = -(-M // chunk_docs) * chunk_docs

    u = rng.random((M_pad, L), dtype=np.float32)
    terms = np.minimum((V * u**skew).astype(np.int32), V - 1)
    tok_idx = np.arange(L, dtype=np.int32)[None, :]
    N_full = np.zeros(M_pad, np.int32)
    N_full[:M] = N
    valid = tok_idx < N_full[:, None]
    counts = (1 + rng.poisson(0.35, size=(M_pad, L))).astype(dtype) * valid
    terms = terms * valid
    doc_mask = np.zeros(M_pad, dtype)
    doc_mask[:M] = 1.0
    return PackedCorpus(
        terms=terms, counts=counts, doc_mask=doc_mask, N=N_full,
        C=counts.sum(1).astype(dtype), M=M, V=V, L=L,
        max_count=int(counts.max()),
    )
