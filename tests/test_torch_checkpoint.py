"""The port's checkpoint and resume against the JAX package's, on CPU.

A checkpoint is the JAX package's format 2 file: a resumed run continues
the ELBO trace of a straight run to 1e-10 in f64 (the JAX package's own
tolerance, tests/test_posthoc.py), a checkpoint written by either
package loads into the other with equal state, and one further step in
each package agrees to 1e-8.  The rest of the JAX package's checkpoint
tests are held here on the port: fingerprints, portability across
chunk sizes, f16 compression, the multi-process directory format, stale
leftovers of a killed run, JSONL rows across a resume, and a SIGKILL of
a training process followed by a resume.
"""

import dataclasses
import json
import os
import signal
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

import topicmodelsvb_jl_tpu as tm
from topicmodelsvb_jl_tpu.parallel.mesh import make_mesh
from topicmodelsvb_jl_tpu.utils.config import RuntimeConfig as JaxRuntimeConfig
import topicmodelsvb_jl_torch as tt
from topicmodelsvb_jl_torch import checkpoint as ckptlib

CORPUS = dict(M=60, V=40, K=3, U=15, seed=5, mean_tokens=20, mean_terms=10, mean_readers=3)
FAMILIES = ("LDA", "fLDA", "CTM", "fCTM", "CTPF")
K = 3
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rt(**kw):
    return tt.RuntimeConfig(chunk_docs=16, dtype="float64", **kw)


def _port(fam, corp, seed=3, **kw):
    return getattr(tt, fam)(corp, K, _rt(**kw), device="cpu", seed=seed)


def _meta(path):
    with np.load(path) as z:
        return json.loads(bytes(z["__meta__"]).decode())


def _rewrite(path, out, edit):
    """Copy the checkpoint ``path`` to ``out`` with ``edit(meta)`` applied."""
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files if k != "__meta__"}
        meta = json.loads(bytes(z["__meta__"]).decode())
    edit(meta)
    with open(out, "wb") as f:
        np.savez(f, __meta__=np.frombuffer(json.dumps(meta).encode(), np.uint8), **arrays)
    return out


def _doc_order(model, name, x):
    x = np.asarray(x)
    return x[model._doc_rows()] if name in model._per_doc_fields else x


def _assert_states_equal(a, b, fields):
    """The states of two models, per-document fields in document order,
    bit for bit."""
    for f in fields:
        np.testing.assert_array_equal(_doc_order(a, f, getattr(a.state, f)),
                                      _doc_order(b, f, getattr(b.state, f)), err_msg=f)


@pytest.fixture(scope="module")
def corpora():
    return dict(jax=tm.synth_corpus(**CORPUS), torch=tt.synth_corpus(**CORPUS))


@pytest.mark.parametrize("fam", FAMILIES)
def test_resume_continues_the_trace(fam, corpora, tmp_path):
    """Save at iteration 3, load, train 2 more: the straight 5-iteration
    run's globals and bound, to 1e-10 (tests/test_posthoc.py:114-136)."""
    corp = corpora["torch"]
    m = _port(fam, corp)
    m.train(iter=3, checkelbo=1, printelbo=False)
    path = str(tmp_path / "ckpt.npz")
    tt.save_checkpoint(path, m)
    resumed = tt.load_checkpoint(path, corp, device="cpu")
    assert type(resumed) is type(m) and resumed.trained_iters == 3
    _assert_states_equal(resumed, m, m._per_doc_fields + ("elbo",))
    resumed.train(iter=2, checkelbo=1, printelbo=False)
    assert [r.k for r in resumed.trainer.trace] == [4, 5]
    straight = _port(fam, corp)
    straight.train(iter=5, checkelbo=1, printelbo=False)
    np.testing.assert_allclose([r.elbo for r in resumed.trainer.trace],
                               [r.elbo for r in straight.trainer.trace[3:]], rtol=1e-10)
    for f in dataclasses.asdict(m.state):
        if f not in m._per_doc_fields:
            np.testing.assert_allclose(getattr(resumed.state, f).numpy(),
                                       getattr(straight.state, f).numpy(), rtol=1e-10,
                                       atol=1e-14, err_msg=f)


@pytest.mark.parametrize("fam", FAMILIES)
def test_checkpoints_cross_between_packages(fam, corpora, tmp_path):
    """A JAX checkpoint loads into the port and a port checkpoint into the
    JAX package, with equal states; one more step in each agrees to 1e-8."""
    jm = getattr(tm, fam)(corpora["jax"], K, runtime=JaxRuntimeConfig(chunk_docs=16,
                          dtype="float64"), mesh=make_mesh(n_devices=1), seed=3)
    jm.train(iter=2, checkelbo=1, printelbo=False)
    jpath = str(tmp_path / "jax.npz")
    tm.save_checkpoint(jpath, jm)
    pm = tt.load_checkpoint(jpath, corpora["torch"], device="cpu")
    assert type(pm).__name__ == fam and pm.trained_iters == 2
    fields = _meta(jpath)["fields"]
    assert sorted(fields) == sorted(dataclasses.asdict(pm.state))
    _assert_states_equal(pm, jm, fields)

    ppath = str(tmp_path / "port.npz")
    tt.save_checkpoint(ppath, pm)
    meta = _meta(ppath)
    # the port writes only knobs the JAX RuntimeConfig takes, and plain dtypes
    assert set(meta["runtime"]) <= {f.name for f in dataclasses.fields(JaxRuntimeConfig)}
    assert meta["dtype"] == "float64"
    jm2 = tm.load_checkpoint(ppath, corpora["jax"])     # the JAX package's default mesh
    assert jm2.trained_iters == 2
    _assert_states_equal(jm2, jm, fields)

    jm2.train(iter=1, checkelbo=1, printelbo=False)
    pm.train(iter=1, checkelbo=1, printelbo=False)
    assert pm.trainer.trace[0].k == jm2.trainer.trace[0].k == 3
    assert abs(pm.elbo - jm2.elbo) <= 1e-8 * abs(jm2.elbo)
    for f in fields:
        if f == "elbo":
            continue
        got, want = (_doc_order(m, f, getattr(m.state, f)) for m in (pm, jm2))
        if f in ("tau", "tau_old"):
            # each document's own token slots: the padding slots past them
            # follow each package's bucket widths
            got, want = (np.concatenate([x[d, :n] for d, n in enumerate(pm.N)])
                         for x in (got, want))
        np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-12, err_msg=f)


def test_runtime_knobs_from_the_jax_package(corpora, tmp_path):
    """The JAX-only knobs that change nothing here are skipped (peak_flops:
    the loading device computes its own), profile_steps and
    elogtheta_f64 load, and a mesh_shape of any axes loads; an unknown
    knob or model raises."""
    jm = tm.LDA(corpora["jax"], K, runtime=JaxRuntimeConfig(chunk_docs=16, dtype="float64",
                use_pallas=False, peak_flops=1.0, profile_steps=7),
                mesh=make_mesh(n_devices=1), seed=3)
    path = str(tmp_path / "jax.npz")
    tm.save_checkpoint(path, jm)
    rt = _meta(path)["runtime"]
    assert {"use_pallas", "data_axis", "vocab_axis", "peak_flops", "profile_steps"} <= set(rt)
    pm = tt.load_checkpoint(path, corpora["torch"], device="cpu")
    assert pm.runtime == tt.RuntimeConfig(chunk_docs=16, dtype="float64", profile_steps=7)
    assert pm.peak_flops == 0.0   # the CPU's, not the checkpoint's
    # any mesh_shape loads (the loading run's mesh is its own; the JAX
    # package never reads the field to build its mesh)
    for name, shape in (("one", [1]), ("mesh", [2, 2])):
        other = _rewrite(path, str(tmp_path / f"{name}.npz"),
                         lambda m, shape=shape: m["runtime"].update(mesh_shape=shape))
        back = tt.load_checkpoint(other, corpora["torch"], device="cpu")
        assert back.M == pm.M and back.runtime == pm.runtime
    f64 = _rewrite(path, str(tmp_path / "f64.npz"),
                   lambda m: m["runtime"].update(elogtheta_f64=True))
    back = tt.load_checkpoint(f64, corpora["torch"], device="cpu")
    assert back.runtime == dataclasses.replace(pm.runtime, elogtheta_f64=True)
    for name, edit, match in (
            ("knob", lambda m: m["runtime"].update(warp_speed=9), "warp_speed"),
            ("model", lambda m: m.update(model="SLDA"), "SLDA")):
        bad = _rewrite(path, str(tmp_path / f"{name}.npz"), edit)
        with pytest.raises(ValueError, match=match):
            tt.load_checkpoint(bad, corpora["torch"], device="cpu")


@pytest.mark.parametrize("fam", ["LDA", "fLDA"])
def test_elogtheta_f64_checkpoints_cross_and_resume(corpora, tmp_path, fam):
    """A float32 run with elogtheta_f64 checkpointed by either package
    resumes in the other with the knob on: 2 iterations, a checkpoint,
    then 2 more in both packages from it, the bounds within 1e-5 relative
    and every field within rtol 1e-5 / atol 1e-6 (float32 rounding in two
    summation orders; the knob's own effect is ~1e-7)."""
    rt_j = JaxRuntimeConfig(chunk_docs=16, elogtheta_f64=True)
    jm = getattr(tm, fam)(corpora["jax"], K, runtime=rt_j, mesh=make_mesh(n_devices=1), seed=3)
    jm.train(iter=2, checkelbo=1, printelbo=False)
    pm = getattr(tt, fam)(corpora["torch"], K, tt.RuntimeConfig(chunk_docs=16,
                                                                 elogtheta_f64=True),
                          device="cpu", seed=3)
    pm.state = type(pm.state)(**{f: torch.tensor(np.asarray(v))
                                 for f, v in jm.state._asdict().items()})
    pm.trained_iters = 2
    for src, save, load, corp in (
            (jm, tm.save_checkpoint, lambda p, c: tt.load_checkpoint(p, c, device="cpu"),
             corpora["torch"]),
            (pm, tt.save_checkpoint, tm.checkpoint.load, corpora["jax"])):
        path = str(tmp_path / f"{type(src).__module__.split('.')[0]}.npz")
        save(path, src)
        assert _meta(path)["runtime"]["elogtheta_f64"] is True
        other = load(path, corp)
        assert other.runtime.elogtheta_f64 and other.trained_iters == 2
        assert other.runtime.dtype == "float32"
        twin = (tt.load_checkpoint(path, corpora["torch"], device="cpu")
                if src is jm else tm.checkpoint.load(path, corpora["jax"]))
        for m in (other, twin):
            m.train(iter=2, checkelbo=1, printelbo=False)
        assert [r.k for r in other.trainer.trace] == [3, 4]
        np.testing.assert_allclose([r.elbo for r in other.trainer.trace],
                                   [r.elbo for r in twin.trainer.trace], rtol=1e-5)
        for f in ("alpha", "beta", "gamma", "Elogtheta"):
            np.testing.assert_allclose(getattr(other, f), getattr(twin, f), rtol=1e-5,
                                       atol=1e-6, err_msg=f)


def test_wrong_corpus_and_stamp_edit_fail_the_fingerprint(tmp_path):
    corp = tt.synth_corpus(M=30, V=20, K=2, seed=1, n_slices=3, drift=0.1, mean_terms=8,
                           mean_tokens=12)
    m = _port("LDA", corp)
    path = str(tmp_path / "m.npz")
    tt.save_checkpoint(path, m)
    with pytest.raises(ValueError, match="fingerprint"):
        tt.load_checkpoint(path, tt.synth_corpus(M=30, V=20, K=2, seed=2), device="cpu")
    edited = tt.Corpus(docs=[tt.Document(terms=d.terms, counts=d.counts, stamp=d.stamp)
                             for d in corp.docs], vocab=dict(corp.vocab))
    edited.docs[0].stamp += 0.5    # same terms, another slice for DTM
    assert ckptlib.corpus_fingerprint(edited) != ckptlib.corpus_fingerprint(corp)
    assert ckptlib.corpus_fingerprint(edited) == tm.checkpoint.corpus_fingerprint(
        tm.Corpus(docs=[tm.Document(terms=d.terms, counts=d.counts, stamp=d.stamp)
                        for d in edited.docs], vocab=dict(edited.vocab)))
    with pytest.raises(ValueError, match="fingerprint"):
        tt.load_checkpoint(path, edited, device="cpu")
    m2 = tt.load_checkpoint(path, edited, strict_corpus=False, device="cpu")
    assert m2.M == m.M


def test_packed_model_hashes_its_pre_bucketing_input(tmp_path):
    """tests/test_packed_api.py:19: a PackedCorpus-built model's checkpoint
    loads from the same packed object, and the resume matches."""
    packed = tt.synth_packed_nsf_scale(M=40, V=60, mean_terms=12, seed=3, chunk_docs=8)
    rt = tt.RuntimeConfig(chunk_docs=8, dtype="float64", pad_multiple=8)
    m = tt.LDA(packed, 3, rt, device="cpu", seed=2)
    assert m.packed is not packed and m.packed.segments is not None
    m.train(iter=3, checkelbo=1, printelbo=False)
    path = str(tmp_path / "m.ckpt")
    tt.save_checkpoint(path, m)
    assert _meta(path)["corpus"] == ckptlib.packed_fingerprint(packed)
    assert _meta(path)["corpus"] == tm.checkpoint.packed_fingerprint(packed)
    m2 = tt.load_checkpoint(path, packed, device="cpu")
    np.testing.assert_array_equal(m2.beta, m.beta)
    m.train(iter=2, checkelbo=1, printelbo=False)
    m2.train(iter=2, checkelbo=1, printelbo=False)
    np.testing.assert_allclose(m2.beta, m.beta, rtol=1e-10)


@pytest.mark.parametrize("fam", ["LDA", "fLDA"])
def test_checkpoint_portable_across_chunk_docs(fam, corpora, tmp_path):
    """Per-document leaves are stored in document order: a checkpoint
    written under one chunking restores under another, whose bucketed row
    permutation and token widths differ."""
    corp = corpora["torch"]
    m = _port(fam, corp)
    m.train(iter=3, checkelbo=float("inf"), printelbo=False)
    path = str(tmp_path / "a.npz")
    tt.save_checkpoint(path, m)
    other = _rewrite(path, str(tmp_path / "b.npz"),
                     lambda meta: meta["runtime"].update(chunk_docs=8, bucket_pad=16))
    m2 = tt.load_checkpoint(other, corp, device="cpu")
    shapes = lambda model: [s.terms.shape for s in model.packed.segments]
    assert m2.chunk_docs == 8 and shapes(m2) != shapes(m)
    np.testing.assert_array_equal(m2.gamma, m.gamma)
    np.testing.assert_array_equal(m2.beta, m.beta)
    if fam == "fLDA":   # tau's token axis follows the packing: each document's own slots
        assert all(np.array_equal(a, b) for a, b in zip(m2.tau, m.tau))
    m.train(iter=1, checkelbo=1, printelbo=False)
    m2.train(iter=1, checkelbo=1, printelbo=False)
    np.testing.assert_allclose(m2.beta, m.beta, rtol=1e-10)


def test_f16_round_trip_and_range_guard(corpora, tmp_path):
    """tests/test_posthoc.py:380: the per-document leaves at f16, the
    globals untouched, the cast back on load; a leaf beyond the f16 range
    stays at full precision."""
    corp = corpora["torch"]
    m = tt.LDA(corp, K, tt.RuntimeConfig(chunk_docs=8, pad_multiple=8), device="cpu", seed=1)
    m.train(iter=3, checkelbo=1, tol=0.0, printelbo=False)
    snap = ckptlib.snapshot(m, compress="f16")
    assert snap[1]["gamma"].dtype == torch.float16 and snap[1]["beta"].dtype == torch.float32
    path = str(tmp_path / "f16.ckpt")
    ckptlib.write_snapshot(path, snap)
    assert _meta(path)["compress"] == "f16"
    r = tt.load_checkpoint(path, corp, device="cpu")
    assert r.state.gamma.dtype == torch.float32
    np.testing.assert_array_equal(r.beta, m.beta)
    np.testing.assert_allclose(r.gamma, m.gamma, rtol=2e-3, atol=1e-3)
    r.train(iter=2, checkelbo=1, tol=0.0, printelbo=False)
    assert np.isfinite(r.elbo)
    with pytest.raises(ValueError):
        ckptlib.snapshot(m, compress="zstd")
    big = m.state.gamma.clone()
    big[0, 0] = 1e5
    m.state = dataclasses.replace(m.state, gamma=big)
    snap2 = ckptlib.snapshot(m, compress="f16")
    assert snap2[1]["gamma"].dtype == torch.float32          # guarded
    assert snap2[1]["Elogtheta"].dtype == torch.float16      # the others still cast
    path2 = str(tmp_path / "f16b.ckpt")
    ckptlib.write_snapshot(path2, snap2)
    assert np.isfinite(tt.load_checkpoint(path2, corp, device="cpu").gamma).all()
    # the JAX package reads the mixed f16/f32 file too
    j = tm.load_checkpoint(path2, corpora["jax"])
    np.testing.assert_array_equal(np.asarray(j.beta), m.beta)
    path3 = str(tmp_path / "f16c.ckpt")
    ckptlib.save(path3, m, compress="f16")
    assert np.isfinite(tt.load_checkpoint(path3, corp, device="cpu").elbo)
    # RuntimeConfig.checkpoint_f16: the auto-checkpoints are f16 snapshots
    auto = tt.LDA(corp, K, tt.RuntimeConfig(chunk_docs=8, checkpoint_every=2, checkpoint_f16=True,
                                            checkpoint_dir=str(tmp_path / "auto")),
                  device="cpu", seed=1)
    auto.train(iter=2, checkelbo=1, printelbo=False)
    meta = _meta(str(tmp_path / "auto" / "ckpt_iter000002"))
    assert meta["compress"] == "f16" and meta["runtime"]["checkpoint_f16"] is True


def test_directory_format_of_a_multiprocess_run_loads(corpora, tmp_path):
    """Two proc{i}.npz shards (per-document leaves keyed by document id,
    the globals in process 0's) plus manifest.json, as the JAX package's
    multi-process save writes them, restore the single-file state."""
    corp = corpora["torch"]
    m = _port("fLDA", corp)
    m.train(iter=2, checkelbo=1, printelbo=False)
    path = str(tmp_path / "one.npz")
    tt.save_checkpoint(path, m)
    meta = _meta(path)
    d = tmp_path / "ckpt_iter000002"
    d.mkdir()
    halves = (np.arange(0, m.M, 2), np.arange(1, m.M, 2))
    with np.load(path) as z:
        for p, ids in enumerate(halves):
            arrays = {}
            for i, name in enumerate(meta["fields"]):
                if name in meta["doc_fields"]:
                    arrays[f"leaf_{i}_ids"] = ids
                    arrays[f"leaf_{i}"] = z[f"leaf_{i}"][ids]
                elif p == 0:
                    arrays[f"leaf_{i}"] = z[f"leaf_{i}"]
            with open(d / f"proc{p}.npz", "wb") as f:
                np.savez(f, **arrays)
    (d / "manifest.json").write_text(json.dumps(dict(meta=meta, n_procs=2)))
    got = tt.load_checkpoint(str(d), corp, device="cpu")
    _assert_states_equal(got, tt.load_checkpoint(path, corp, device="cpu"), meta["fields"])
    assert got.trained_iters == 2
    (d / "proc1.npz").unlink()
    (d / "manifest.json").write_text(json.dumps(dict(meta=meta, n_procs=1)))
    with pytest.raises(ValueError, match="covers"):
        tt.load_checkpoint(str(d), corp, device="cpu")


def test_same_iteration_leftovers_are_replaced(corpora, tmp_path, monkeypatch):
    """tests/test_faultinjection.py:186-240: a killed run's leftover
    directory and stale .tmp are replaced by the file; a final file that
    exists is replaced by os.replace alone, never removed first."""
    ckpt_dir = tmp_path / "ck"
    for name in ("ckpt_iter000002", "ckpt_iter000002.tmp"):
        (ckpt_dir / name).mkdir(parents=True)
        (ckpt_dir / name / "proc0.npz").write_bytes(b"stale")
    corp = corpora["torch"]
    removed = []
    real_remove = os.remove
    monkeypatch.setattr(os, "remove", lambda p: (removed.append(p), real_remove(p)))
    for _ in range(2):   # the second run writes every final file over an existing one
        m = tt.LDA(corp, 2, tt.RuntimeConfig(chunk_docs=8, pad_multiple=8, checkpoint_every=2,
                                             checkpoint_dir=str(ckpt_dir)), device="cpu", seed=1)
        m.train(iter=4, tol=0.0, checkelbo=1, printelbo=False)
    assert sorted(os.listdir(ckpt_dir)) == ["ckpt_iter000002", "ckpt_iter000004"]
    final = ckpt_dir / "ckpt_iter000002"
    assert final.is_file()
    assert not any(p.endswith(("ckpt_iter000002", "ckpt_iter000004")) for p in removed), removed
    assert tt.load_checkpoint(str(final), corp, device="cpu").trained_iters == 2


def test_writer_error_surfaces_and_training_error_stays_primary(corpora, tmp_path,
                                                               monkeypatch):
    corp = corpora["torch"]
    rt = tt.RuntimeConfig(chunk_docs=8, checkpoint_every=1, checkpoint_dir=str(tmp_path))

    def broken(path, snap):
        raise OSError("disk full")

    monkeypatch.setattr(ckptlib, "write_snapshot", broken)
    m = tt.LDA(corp, 2, rt, device="cpu", seed=1)
    with pytest.raises(OSError, match="disk full"):
        m.train(iter=2, checkelbo=1, printelbo=False)
    m = tt.LDA(corp, 2, rt, device="cpu", seed=1)

    def failing_step(*a):
        raise RuntimeError("step failed")

    real_build = m._build_trainer

    def build(cfg):
        tr = real_build(cfg)
        steps = iter([tr.step_fn, failing_step])
        tr.step_fn = lambda *a: next(steps)(*a)
        return tr

    m._build_trainer = build
    with pytest.raises(RuntimeError, match="step failed"):
        m.train(iter=3, checkelbo=1, printelbo=False)


def test_jsonl_rows_continue_k_across_a_resume(corpora, tmp_path):
    corp = corpora["torch"]
    log = tmp_path / "metrics.jsonl"
    m = _port("LDA", corp, metrics_path=str(log))
    m.train(iter=3, checkelbo=1, printelbo=False)
    path = str(tmp_path / "m.npz")
    tt.save_checkpoint(path, m)
    assert "metrics_path" not in _meta(path)["runtime"]
    r = tt.load_checkpoint(path, corp, device="cpu")
    r.runtime = dataclasses.replace(r.runtime, metrics_path=str(log))
    r.train(iter=2, checkelbo=1, printelbo=False)
    rows = [json.loads(line) for line in log.read_text().splitlines()]
    assert [row["k"] for row in rows] == [1, 2, 3, 4, 5]
    assert all(row["elbo"] is not None and row["step_time_s"] > 0 for row in rows)
    np.testing.assert_allclose([row["elbo"] for row in rows[3:]],
                               [x.elbo for x in r.trainer.trace], rtol=0)


@pytest.mark.parametrize("checkelbo, want", [
    (2, ["sync", "snapshot", "snapshot", "sync", "snapshot"]),
    (1, ["snapshot"] * 3),
])
def test_checkpoint_clock_starts_after_the_open_span_is_synced(corpora, tmp_path, monkeypatch,
                                                               checkelbo, want):
    """The callback's wall time leaves the step timings, so the device
    work queued before it must not run inside it: an iteration that no
    ELBO check has synced waits for the device before the callback."""
    from topicmodelsvb_jl_torch import engine

    events = []
    sync, snap = engine._synchronize, ckptlib.snapshot
    monkeypatch.setattr(engine, "_synchronize",
                        lambda *a, **k: (events.append("sync"), sync(*a, **k))[1])
    monkeypatch.setattr(ckptlib, "snapshot",
                        lambda *a, **k: (events.append("snapshot"), snap(*a, **k))[1])
    m = _port("LDA", corpora["torch"], checkpoint_every=1, checkpoint_dir=str(tmp_path))
    m.train(iter=3, checkelbo=checkelbo, printelbo=False)
    assert events == want
    assert _done(str(tmp_path)) == [f"ckpt_iter{k:06d}" for k in (1, 2, 3)]


_WORKER = textwrap.dedent("""
    import sys
    sys.path.insert(0, {root!r})
    import topicmodelsvb_jl_torch as tt
    corp = tt.synth_corpus(M=64, V=40, K=3, seed=21)
    rt = tt.RuntimeConfig(chunk_docs=8, dtype="float64", pad_multiple=8,
                          checkpoint_every=2, checkpoint_dir=sys.argv[1])
    tt.LDA(corp, 3, rt, device="cpu", seed=9).train(iter=100_000, tol=0.0, checkelbo=1,
                                                    printelbo=False)
""")


def _done(ckpt_dir):
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(f for f in os.listdir(ckpt_dir)
                  if f.startswith("ckpt_iter") and not f.endswith(".tmp"))


def test_sigkill_and_resume_reproduces_the_trace(tmp_path):
    """tests/test_faultinjection.py:41 on the port: SIGKILL a training
    process once it has written two checkpoints, resume from the last one,
    and continue the uninterrupted trace to 1e-10 with the global
    iteration numbers."""
    ckpt_dir = str(tmp_path / "ckpts")
    proc = subprocess.Popen([sys.executable, "-c", _WORKER.format(root=ROOT), ckpt_dir],
                            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    try:
        t0 = time.time()
        while len(_done(ckpt_dir)) < 2:
            assert proc.poll() is None, proc.stderr.read()
            assert time.time() - t0 < 60, "the worker wrote no checkpoints in 60 s"
            time.sleep(0.02)
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    assert proc.returncode == -signal.SIGKILL
    last = _done(ckpt_dir)[-1]
    k_ckpt = int(last.replace("ckpt_iter", ""))
    assert k_ckpt >= 4 and k_ckpt % 2 == 0
    total = k_ckpt + 4
    corp = tt.synth_corpus(M=64, V=40, K=3, seed=21)
    rt = tt.RuntimeConfig(chunk_docs=8, dtype="float64", pad_multiple=8)
    ref = tt.LDA(corp, 3, rt, device="cpu", seed=9)
    ref.train(iter=total, tol=0.0, checkelbo=1, printelbo=False)
    resumed = tt.load_checkpoint(os.path.join(ckpt_dir, last), corp, device="cpu")
    assert resumed.trained_iters == k_ckpt
    resumed.train(iter=total - k_ckpt, tol=0.0, checkelbo=1, printelbo=False)
    np.testing.assert_allclose([r.elbo for r in resumed.trainer.trace],
                               [r.elbo for r in ref.trainer.trace[k_ckpt:]], rtol=1e-10)
    np.testing.assert_allclose(resumed.beta, ref.beta, rtol=1e-10)
    assert [r.k for r in resumed.trainer.trace] == list(range(k_ckpt + 1, total + 1))
    assert resumed.trained_iters == total
