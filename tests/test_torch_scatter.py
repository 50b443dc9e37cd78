"""The M-step scatter's plan and plain version, on CPU.

The plan keeps the slots whose weight factor is nonzero, stably sorted by
id and cut into pieces of at most ``piece_rows``; the plain version adds
each id's kept rows in slot order, so on the CPU it is bitwise equal to
``index_add_`` over all rows, provided every family's weights are exactly
0 on the slots the plan leaves out.  Both are checked here on real
weights from one step of every family; the plain version is also held to
the JAX package's ``count_scatter`` (what ``bench_scatter_pallas.py``
holds ``pallas_once`` to) in f64 within 1e-12 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from topicmodelsvb_jl_tpu.ops.segment import count_scatter as jax_count_scatter
import topicmodelsvb_jl_torch as tt
from topicmodelsvb_jl_torch.kernels.scatter_rows import build_plan, scatter_rows, scatter_rows_ref
from topicmodelsvb_jl_torch.models import ctm, ctpf, fctm, flda, lda
from topicmodelsvb_jl_torch.models.lda import _chunks


def _zipf_chunk(T, V, seed, zero_share=0.3):
    """Zipf-like ids with zero-weight slots that point at id 0, as padding does."""
    r = np.random.default_rng(seed)
    ids = np.minimum((V * r.random(T) ** 3).astype(np.int32), V - 1)
    keep = r.random(T) >= zero_share
    ids[~keep] = 0
    return ids, keep


@pytest.mark.parametrize("T,V,piece_rows", [(5000, 300, 256), (5000, 300, 7), (600, 1, 64),
                                            (0, 10, 256), (40, 1000, 1)])
def test_plan_layout(T, V, piece_rows):
    """A stable sort of exactly the kept slots, runs of one id, pieces of at
    most ``piece_rows``, and split runs' scratch rows in piece order."""
    ids, keep = _zipf_chunk(T, V, seed=T + V)
    p = build_plan(ids.reshape(-1, 10), keep.reshape(-1, 10), piece_rows)   # a [B, L] chunk
    rows, sid = p.rows.numpy(), p.ids.numpy()
    assert p.T == T and sorted(rows.tolist()) == np.flatnonzero(keep).tolist()
    assert np.array_equal(sid, ids[rows]) and np.all(np.diff(sid) >= 0)
    same = sid[1:] == sid[:-1]
    assert np.all(np.diff(rows)[same] > 0)                    # stable: slot order per id
    ps = p.piece_start.numpy()
    assert ps[0] == 0 and ps[-1] == rows.size and np.all(np.diff(ps) >= 1)
    assert np.all(np.diff(ps) <= piece_rows)
    for a, b, pid in zip(ps[:-1], ps[1:], p.piece_id.numpy()):
        assert np.all(sid[a:b] == pid)
    out, rs = p.piece_out.numpy(), p.run_start.numpy()
    whole = out < 0
    assert len(set(p.piece_id.numpy()[whole])) == whole.sum()  # one writer per acc row
    assert np.array_equal(out[~whole], np.arange(p.n_scratch)) and rs[-1] == p.n_scratch
    for r, rid in enumerate(p.run_id.numpy()):
        pieces = np.flatnonzero(~whole)[rs[r]:rs[r + 1]]
        assert rs[r + 1] - rs[r] >= 2 and np.all(p.piece_id.numpy()[pieces] == rid)
        assert rid not in p.piece_id.numpy()[whole]
    assert p.max_id == (sid.max() if sid.size else -1)


@pytest.mark.parametrize("T,V,piece_rows", [(5000, 300, 256), (5000, 300, 7), (600, 1, 64),
                                            (0, 10, 256), (40, 1000, 1), (20_000, 3000, 256)])
def test_plan_tasks_layout(T, V, piece_rows):
    """The float64 mode's tasks: every piece once as (row start, rows, id,
    out), the pieces of more than LONG_ROWS rows first, each part in piece
    order, and n_long of them."""
    from topicmodelsvb_jl_torch.kernels.scatter_rows import LONG_ROWS

    ids, keep = _zipf_chunk(T, V, seed=T + V + 1)
    p = build_plan(ids, keep, piece_rows)
    ps = p.piece_start.numpy()
    tasks = p.tasks.numpy()
    assert p.tasks.dtype == torch.int32 and tasks.shape == (4 * p.n_pieces,)
    tasks = tasks.reshape(-1, 4)
    rows = np.diff(ps)
    want = np.stack([ps[:-1], rows, p.piece_id.numpy(), p.piece_out.numpy()], axis=1)
    long_ = rows > LONG_ROWS
    assert p.n_long == long_.sum()
    assert np.array_equal(tasks[:p.n_long], want[long_])
    assert np.array_equal(tasks[p.n_long:], want[~long_])
    if T == 20_000:
        assert 0 < p.n_long < p.n_pieces   # both kinds


def test_streamed_plans_keep_the_tasks():
    """A streamed batch's plans staged as one int32 buffer come back as
    views with every field, the tasks and n_long included."""
    from topicmodelsvb_jl_torch import streaming

    plans = [build_plan(*_zipf_chunk(T, V, seed=T), piece_rows=32)
             for T, V in ((3000, 40), (0, 5), (700, 900))]
    flat, metas = streaming._flatten_plans(plans)
    for a, b in zip(plans, streaming._plan_views(torch.from_numpy(flat), metas)):
        assert (a.T, a.max_id, a.n_scratch, a.n_long) == (b.T, b.max_id, b.n_scratch, b.n_long)
        for f in ("rows", "ids", "piece_start", "piece_id", "piece_out", "run_start", "run_id",
                  "tasks"):
            assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_plan_rejects_bad_input():
    with pytest.raises(ValueError, match="differ"):
        build_plan(np.zeros(4, np.int32), np.ones(5, bool))
    with pytest.raises(ValueError, match="ids must lie"):
        build_plan(np.array([1, -2], np.int32), np.ones(2, bool))
    with pytest.raises(ValueError, match="piece_rows"):
        build_plan(np.zeros(4, np.int32), np.ones(4, bool), piece_rows=0)


def test_plan_checks_its_index_tensors_once_and_keeps_its_scratch():
    """A plan's index tensors are checked when it is built or moved; its
    scratch rows are made once per width and not carried by ``to``."""
    import dataclasses

    ids, keep = _zipf_chunk(5000, 40, seed=9)
    p = build_plan(ids, keep, piece_rows=8)
    assert p.n_scratch > 0 and p.device == torch.device("cpu")
    a = p.scratch_rows(7)
    assert a.shape == (p.n_scratch, 7) and p.scratch_rows(7) is a
    assert p.scratch_rows(3).shape == (p.n_scratch, 3)
    moved = p.to("cpu")
    assert moved.scratch == {} and torch.equal(moved.rows, p.rows)
    with pytest.raises(TypeError, match="run_id"):
        dataclasses.replace(p, run_id=p.run_id.long())
    with pytest.raises(ValueError, match="run_start"):
        dataclasses.replace(p, run_start=p.run_start[:-1])
    with pytest.raises(ValueError, match="contiguous"):
        dataclasses.replace(p, rows=torch.stack([p.rows, p.rows], 1)[:, 0])
    with pytest.raises(ValueError, match="piece_start is on meta"):
        dataclasses.replace(p, piece_start=p.piece_start.to("meta"))


def test_plain_matches_jax_count_scatter_in_f64():
    ids, keep = _zipf_chunk(20_000, 700, seed=1)
    r = np.random.default_rng(2)
    w = r.random((ids.size, 9)) * keep[:, None]
    want = np.asarray(jax_count_scatter(jnp.asarray(w), jnp.asarray(ids), 700))
    got = scatter_rows(torch.zeros(700, 9, dtype=torch.float64), torch.tensor(w),
                       build_plan(ids, keep, piece_rows=16)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    assert np.any(got != 0)


def test_wrapper_takes_plain_version_on_cpu_and_raises_elsewhere():
    ids, keep = _zipf_chunk(3000, 50, seed=3)
    w = torch.rand(3000, 5) * torch.tensor(keep)[:, None]
    plan = build_plan(ids, keep)
    before = scatter_rows.launches
    a = scatter_rows(torch.ones(50, 5), w, plan)
    assert torch.equal(a, scatter_rows_ref(torch.ones(50, 5), w, plan))
    assert scatter_rows.launches == before
    with pytest.raises(ValueError, match="no kernel"):
        scatter_rows(torch.zeros(50, 5, device="meta"), w.to("meta"), plan.to("meta"))


# one step of every family on CPU (f32), the scatter's calls recorded
SMALL = dict(M=300, V=150, mean_terms=18, seed=4, chunk_docs=32)


def _family(name):
    rt = tt.RuntimeConfig(chunk_docs=32)
    if name == "ctpf":
        corp = tt.synth_corpus(M=200, V=120, K=4, U=60, seed=3, mean_tokens=30,
                               mean_terms=15, mean_readers=3)
        packed = tt.pack_corpus(corp, with_readers=True)
        return tt.CTPF(packed, 5, rt, device="cpu", seed=1), ctpf
    cls = {"lda": (tt.LDA, lda), "flda": (tt.fLDA, flda), "ctm": (tt.CTM, ctm),
           "fctm": (tt.fCTM, fctm)}[name]
    return cls[0](tt.synth_packed_nsf_scale(**SMALL), 5, rt, device="cpu", seed=1), cls[1]


@pytest.mark.parametrize("name", ["lda", "flda", "ctpf", "ctm", "fctm"])
def test_plain_with_plan_is_index_add_on_real_weights(name, monkeypatch):
    """Each family's weights are exactly 0 on every slot its plan leaves
    out, and the plan's scatter is bitwise the scatter over all slots."""
    model, module = _family(name)
    calls = []

    def record(acc, weights, plan):
        calls.append((acc.clone(), weights.clone(), plan))
        return scatter_rows(acc, weights, plan)

    monkeypatch.setattr(module, "count_scatter_into", record)
    model.train(iter=1, checkelbo=float("inf"), printelbo=False)
    p = model.packed
    all_ids = [p.segments[j].terms[sl].reshape(-1) for _, j, sl in _chunks(p, model.chunk_docs)]
    if name == "ctpf":   # the term and the reader scatter alternate
        readers = [p.readers[rows].reshape(-1) for rows, _, _ in _chunks(p, model.chunk_docs)]
        all_ids = [x for pair in zip(all_ids, readers) for x in pair]
    assert len(calls) == len(all_ids) >= 4
    dropped = 0
    for (acc, w, plan), ids in zip(calls, all_ids):
        left_out = np.ones(plan.T, bool)
        left_out[plan.rows.numpy()] = False
        assert torch.all(w[torch.from_numpy(left_out)] == 0)
        dropped += left_out.sum()
        want = acc.clone().index_add_(0, torch.from_numpy(ids), w)
        assert torch.equal(scatter_rows_ref(acc, w, plan), want)
    assert dropped > 0
