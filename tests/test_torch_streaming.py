"""The port's host-streamed training (``topicmodelsvb_jl_torch/streaming.py``)
against the JAX package's ``streaming.py``, on the CPU in float64: the
packing utilities, the scaffold, ``StreamingLDA`` and ``StreamingCTPF``.
The other five families are in ``test_torch_streaming_families.py``, which
imports this file's helpers.

Both packages start from one state (the JAX model's init carried across
with ``convert.streaming_from``: the two RNGs draw different numbers) and
are compared per iteration and per online epoch to 1e-8; the port's
streamed trajectory against its own in-memory model (same seed, same
init) to 1e-10; and the batch partition, resumes and the state_dir run
bitwise.
"""

import dataclasses
import json
import os
import signal
import subprocess
import sys
import textwrap
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import topicmodelsvb_jl_tpu as tm
from topicmodelsvb_jl_tpu import evaluate as jax_evaluate
from topicmodelsvb_jl_tpu import streaming as jst
from topicmodelsvb_jl_tpu.datasets import synth_packed_nsf_scale
from topicmodelsvb_jl_tpu.ops import packing as jpk
import topicmodelsvb_jl_torch as tt
from topicmodelsvb_jl_torch import convert
from topicmodelsvb_jl_torch import evaluate as port_evaluate
from topicmodelsvb_jl_torch import streaming as pst
from topicmodelsvb_jl_torch.ops import packing as ppk

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL_JAX, RTOL_SELF = 1e-8, 1e-10


def port_packed(pk):
    """The port's PackedCorpus holding the same arrays as a JAX one."""
    return ppk.PackedCorpus(**{f.name: getattr(pk, f.name)
                               for f in dataclasses.fields(ppk.PackedCorpus)})


def lda_packed(M=96, V=50, seed=4):
    return synth_packed_nsf_scale(M=M, V=V, mean_terms=10, seed=seed, chunk_docs=16,
                                  pad_multiple=8)


def reader_packed(M=96, V=50, U=20, seed=4):
    corp = tm.synth_corpus(M=M, V=V, U=U, K=3, seed=seed, mean_terms=10, mean_readers=3)
    return jpk.pack_corpus(corp, pad_multiple=8, docs_multiple=32, with_readers=True,
                           dtype=np.float64)


def pair(name, pk, K=3, batch_docs=32, chunk_docs=16, **ctor):
    """The JAX and the port's streaming ``name`` on one corpus, both f64,
    the port's state set from the JAX model's."""
    j = getattr(jst, name)(pk, K, batch_docs=batch_docs, chunk_docs=chunk_docs,
                           dtype=jnp.float64, seed=3, **ctor)
    p = getattr(pst, name)(port_packed(pk), K, batch_docs=batch_docs,
                           chunk_docs=chunk_docs, dtype=torch.float64, seed=3,
                           device="cpu", **ctor)
    convert.streaming_from(p, j)
    return j, p


def frozen(j):
    """A JAX streaming model whose next train calls reuse its jitted
    functions (it builds them anew on every call otherwise)."""
    j._compile = lambda cfg: None
    return j


def host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_same(p, j, rtol, what):
    """Globals, host per-document state and trace of two streaming models
    (either package) within ``rtol`` of each entry or of the array's
    largest entry (an entry near 0 carries the rounding of its array's
    scale); ``rtol=0`` asks for bitwise equality."""
    for n in p._globals + p._doc_state:
        a, b = host(getattr(p, n)), host(getattr(j, n))
        if rtol == 0:
            np.testing.assert_array_equal(a, b, err_msg=f"{what}: {n}")
        else:
            np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * np.abs(b).max(),
                                       err_msg=f"{what}: {n}")
    assert [t[0] for t in p.trace] == [t[0] for t in j.trace], what
    if rtol == 0:
        assert [t[1] for t in p.trace] == [t[1] for t in j.trace], what
    else:
        np.testing.assert_allclose([t[1] for t in p.trace], [t[1] for t in j.trace],
                                   rtol=rtol, err_msg=f"{what}: trace")
    for n in ("trained_iters", "_svi_t", "_epochs_done"):
        assert getattr(p, n) == getattr(j, n), f"{what}: {n}"


def follow_train(j, p, iters, what, **kw):
    """``train(iter=1)`` ``iters`` times on both, compared after each."""
    for i in range(iters):
        j.train(iter=1, tol=0.0, printelbo=False, **kw)
        frozen(j)
        p.train(iter=1, tol=0.0, printelbo=False, **kw)
        assert_same(p, j, RTOL_JAX, f"{what} iteration {i + 1}")


def follow_online(j, p, epochs, what, **kw):
    for e in range(epochs):
        j.train_online(epochs=1, printelbo=False, **kw)
        frozen(j)
        p.train_online(epochs=1, printelbo=False, **kw)
        assert_same(p, j, RTOL_JAX, f"{what} epoch {e + 1}")
        for a, b in zip(p._stats_to_leaves(p._svi_stats), j._svi_stats):
            b = np.asarray(b)
            np.testing.assert_allclose(host(a), b, rtol=RTOL_JAX,
                                       atol=RTOL_JAX * np.abs(b).max())


def check_checkpoints(name, pk, tmp_path, train_kw, online_kw, **ctor):
    """Checkpoints crossing both ways with equal states, and resumes,
    batch and online, equal to the straight run."""
    # the port's file into the JAX package and the JAX file into the port
    j, p = pair(name, pk, **ctor)
    j.train(iter=2, tol=0.0, printelbo=False, **train_kw)
    frozen(j)
    p.train(iter=2, tol=0.0, printelbo=False, **train_kw)
    jpath, ppath = str(tmp_path / f"{name}_jax.npz"), str(tmp_path / f"{name}_port.npz")
    j.save(jpath)
    p.save(ppath)
    from_jax = pst.load(jpath, port_packed(pk), device="cpu")
    from_port = jst.load(ppath, pk)
    assert type(from_jax) is type(p) and type(from_port) is type(j)
    assert_same(from_jax, j, 0, f"{name}: JAX file in the port")
    assert_same(p, from_port, 0, f"{name}: port file in the JAX package")
    # one more iteration from each loaded model: the two packages agree
    from_jax.train(iter=1, tol=0.0, printelbo=False, **train_kw)
    j.train(iter=1, tol=0.0, printelbo=False, **train_kw)
    assert_same(from_jax, j, RTOL_JAX, f"{name}: resumed from the JAX file")

    # batch resume within the port, bitwise the straight run
    ref = getattr(pst, name)(port_packed(pk), 3, batch_docs=32, chunk_docs=16,
                             dtype=torch.float64, seed=3, device="cpu", **ctor)
    convert.streaming_from(ref, pair(name, pk, **ctor)[0])
    half = getattr(pst, name)(port_packed(pk), 3, batch_docs=32, chunk_docs=16,
                              dtype=torch.float64, seed=3, device="cpu", **ctor)
    convert.streaming_from(half, ref)
    ref.train(iter=3, tol=0.0, printelbo=False, **train_kw)
    half.train(iter=2, tol=0.0, printelbo=False, **train_kw)
    half.save(ppath)
    back = pst.load(ppath, port_packed(pk), device="cpu")
    assert back.trained_iters == 2
    back.train(iter=1, tol=0.0, printelbo=False, **train_kw)
    assert_same(back, ref, 0, f"{name}: batch resume")

    # online resume: one epoch, save, load, one more epoch
    ref = getattr(pst, name)(port_packed(pk), 3, batch_docs=32, chunk_docs=16,
                             dtype=torch.float64, seed=3, device="cpu", **ctor)
    convert.streaming_from(ref, pair(name, pk, **ctor)[0])
    half = getattr(pst, name)(port_packed(pk), 3, batch_docs=32, chunk_docs=16,
                              dtype=torch.float64, seed=3, device="cpu", **ctor)
    convert.streaming_from(half, ref)
    ref.train_online(epochs=2, printelbo=False, **online_kw)
    half.train_online(epochs=1, printelbo=False, **online_kw)
    half.save(ppath)
    back = pst.load(ppath, port_packed(pk), device="cpu")
    assert back._epochs_done == 1 and back._svi_t == half._svi_t
    back.train_online(epochs=1, printelbo=False, **online_kw)
    assert_same(back, ref, 0, f"{name}: online resume")


def check_directory_format(name, pk, tmp_path, train_kw, nproc=2, **ctor):
    """A JAX multi-process run's directory checkpoint, built from fake
    shards of a trained JAX model (each process holds the p-th L-row slice
    of every global batch), loads on one process equal to that model."""
    j = getattr(jst, name)(pk, 3, batch_docs=32, chunk_docs=16, dtype=jnp.float64, seed=3,
                           **ctor)
    j.train(iter=1, tol=0.0, printelbo=False, **train_kw)
    single = str(tmp_path / f"{name}_single.npz")
    j.save(single)
    d = tmp_path / f"{name}_dir"
    d.mkdir()
    G = 32
    L = G // nproc
    with np.load(single) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        arrays = {k: z[k] for k in z.files if k != "__meta__"}
    for pid in range(nproc):
        r = np.arange(pk.M_pad // nproc)
        rows = (r // L) * G + pid * L + (r % L)
        m = dict(meta, nproc=nproc, row_map=dict(L=L, G=G, pid=pid))
        shard = {k: (v[rows] if k.startswith("doc_") else v) for k, v in arrays.items()}
        with open(d / f"proc{pid}.npz", "wb") as f:
            np.savez(f, __meta__=np.frombuffer(json.dumps(m).encode(), np.uint8), **shard)
    (d / "manifest.json").write_text(json.dumps(dict(format=1, nproc=nproc, cls=name)))
    got = pst.load(str(d), port_packed(pk), device="cpu")
    assert_same(got, j, 0, f"{name}: directory format")
    (d / f"proc{nproc}.npz").write_bytes(b"")      # a stale extra shard
    with pytest.raises(ValueError, match="shard mismatch"):
        pst.load(str(d), port_packed(pk), device="cpu")


FAMILIES = {
    "StreamingLDA": (lda_packed, "LDA", {}),
    "StreamingCTPF": (reader_packed, "CTPF", {}),
}


# ── packing utilities ──

def test_save_packed_directories_are_byte_identical_and_cross(tmp_path):
    for pk in (lda_packed(), reader_packed()):
        jd, pd = tmp_path / "jax", tmp_path / "port"
        jpk.save_packed(str(jd), pk)
        ppk.save_packed(str(pd), port_packed(pk))
        assert sorted(os.listdir(jd)) == sorted(os.listdir(pd))
        for f in os.listdir(jd):
            assert (jd / f).read_bytes() == (pd / f).read_bytes(), f
        for loaded in (ppk.load_packed(str(jd)), jpk.load_packed(str(pd))):
            for f in ("terms", "counts", "doc_mask", "N", "C", "readers", "ratings", "R"):
                a, b = getattr(loaded, f), getattr(pk, f)
                assert (a is None) == (b is None), f
                if a is not None:
                    np.testing.assert_array_equal(np.asarray(a), b, err_msg=f)
            assert (loaded.M, loaded.V, loaded.L, loaded.U, loaded.Rmax, loaded.max_count) == \
                (pk.M, pk.V, pk.L, pk.U, pk.Rmax, pk.max_count)
        mm = ppk.load_packed(str(pd))
        assert isinstance(mm.terms, np.memmap) and not mm.terms.flags.writeable
        for d in (jd, pd):
            for f in os.listdir(d):
                os.remove(d / f)
            os.rmdir(d)
    with pytest.raises(ValueError, match="dense"):
        ppk.save_packed(str(tmp_path / "b"), ppk.bucketize_packed(port_packed(lda_packed()), 16))


@pytest.mark.parametrize("users", [False, True])
def test_trim_packed_matches_jax(users):
    pk = reader_packed(V=80, U=40)
    want = jpk.trim_packed(pk, chunk_rows=40, users=users)
    got = ppk.trim_packed(port_packed(pk), chunk_rows=40, users=users)
    assert len(got) == len(want)
    for f in ("terms", "readers", "counts"):
        np.testing.assert_array_equal(getattr(got[0], f), getattr(want[0], f))
    assert (got[0].V, got[0].U) == (want[0].V, want[0].U)
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="reader arrays"):
        ppk.trim_packed(port_packed(lda_packed()), users=True)


# ── per family: LDA and CTPF ──

@pytest.mark.parametrize("name", list(FAMILIES))
def test_train_follows_jax_per_iteration(name):
    make, _, train_kw = FAMILIES[name]
    j, p = pair(name, make())
    follow_train(j, p, 3, name, viter=5, **train_kw)


@pytest.mark.parametrize("name", list(FAMILIES))
def test_streamed_trajectory_is_the_in_memory_one(name):
    """Same seed, same init: the port's streamed model and its in-memory
    api model (bucketed chunks, compensated sums) to 1e-10."""
    make, api_name, train_kw = FAMILIES[name]
    pk = port_packed(make())
    s = getattr(pst, name)(pk, 3, batch_docs=32, chunk_docs=16, dtype=torch.float64,
                           seed=3, device="cpu")
    s.train(iter=3, tol=0.0, viter=5, printelbo=False, **train_kw)
    m = getattr(tt, api_name)(pk, 3, tt.RuntimeConfig(chunk_docs=16, dtype="float64"),
                              device="cpu", seed=3)
    m.train(iter=3, tol=0.0, viter=5, printelbo=False, **train_kw)
    rows = m._doc_rows()
    for n in s._globals:
        np.testing.assert_allclose(host(getattr(s, n)), host(getattr(m.state, n)),
                                   rtol=RTOL_SELF, atol=1e-13, err_msg=n)
    for n in s._doc_state:
        np.testing.assert_allclose(getattr(s, n)[: s.M], host(getattr(m.state, n))[rows],
                                   rtol=RTOL_SELF, atol=1e-13, err_msg=n)
    np.testing.assert_allclose([t[1] for t in s.trace], [r.elbo for r in m.trainer.trace],
                               rtol=RTOL_SELF)


@pytest.mark.parametrize("name", list(FAMILIES))
def test_batch_docs_changes_no_bit(name):
    make, _, train_kw = FAMILIES[name]
    pk = port_packed(make())
    runs = []
    for batch in (96, 32, 16):
        s = getattr(pst, name)(pk, 3, batch_docs=batch, chunk_docs=16,
                               dtype=torch.float64, seed=3, device="cpu")
        s.train(iter=2, tol=0.0, viter=5, printelbo=False, **train_kw)
        runs.append(s)
    for s in runs[1:]:
        assert_same(s, runs[0], 0, f"{name} batch_docs {s.batch_docs}")


@pytest.mark.parametrize("name", list(FAMILIES))
def test_train_online_follows_jax_per_epoch(name):
    make, _, _ = FAMILIES[name]
    j, p = pair(name, make())
    follow_online(j, p, 2, name, viter=4, tau0=8.0, shuffle_seed=5)


@pytest.mark.parametrize("name", list(FAMILIES))
def test_checkpoints_cross_and_resume(name, tmp_path):
    make, _, train_kw = FAMILIES[name]
    check_checkpoints(name, make(), tmp_path, dict(viter=4, **train_kw),
                      dict(viter=4, tau0=8.0, shuffle_seed=5))


@pytest.mark.parametrize("name", list(FAMILIES))
def test_jax_directory_format_loads_on_one_process(name, tmp_path):
    make, _, train_kw = FAMILIES[name]
    check_directory_format(name, make(), tmp_path, dict(viter=4, **train_kw))


# ── once each ──

def test_state_dir_on_a_load_packed_corpus_equals_the_ram_run(tmp_path):
    pk = port_packed(lda_packed())
    ram = pst.StreamingLDA(pk, 3, batch_docs=32, chunk_docs=16, dtype=torch.float64, seed=3,
                           device="cpu")
    ram.train(iter=3, viter=5, tol=0.0, printelbo=False)
    ppk.save_packed(str(tmp_path / "corp"), pk)
    disk = ppk.load_packed(str(tmp_path / "corp"))
    sd = str(tmp_path / "state")
    dm = pst.StreamingLDA(disk, 3, batch_docs=32, chunk_docs=16, dtype=torch.float64,
                          seed=3, state_dir=sd, device="cpu")
    assert isinstance(dm.gamma, np.memmap)
    dm.train(iter=3, viter=5, tol=0.0, printelbo=False)
    assert_same(dm, ram, 0, "state_dir")
    np.testing.assert_array_equal(np.load(os.path.join(sd, "gamma.npy")), ram.gamma)


def test_ctpf_bound_without_its_global_terms():
    """The summed ``elbo_chunk`` parts plus ``global_terms`` are the whole
    ``make_elbo`` bound, as the streamed sweep adds the global terms once."""
    from topicmodelsvb_jl_torch.models import ctpf as ctpf_mod
    from topicmodelsvb_jl_torch.utils.numerics import elbo_value

    m = tt.CTPF(port_packed(reader_packed()), 3,
                tt.RuntimeConfig(chunk_docs=16, dtype="float64"), device="cpu", seed=3)
    m.train(iter=2, tol=0.0, viter=4, printelbo=False)
    terms, counts, readers, ratings, doc_mask = m._step_data()
    whole = elbo_value(ctpf_mod.make_elbo(m.packed, 3, 16)(m.state, terms, counts, readers,
                                                           ratings, doc_mask))
    st = m.state
    tb = ctpf_mod.elbo_tables(st, m.packed.U)
    parts = float(ctpf_mod.global_terms(tb))
    for rows, j, sl in ctpf_mod._chunks(m.packed, 16):
        doc, tok = ctpf_mod.elbo_chunk(tb, terms[j][sl], counts[j][sl], readers[rows],
                                       ratings[rows], doc_mask[j][sl], st.gimel[rows],
                                       st.gimel_old[rows], st.zayin[rows], st.zayin_old[rows])
        parts += float(doc) + float(tok)
    np.testing.assert_allclose(parts, whole, rtol=1e-12)


def test_to_model_carries_the_streamed_state():
    pk = port_packed(lda_packed(M=64, V=40, seed=13))
    s = pst.StreamingLDA(pk, 3, batch_docs=32, chunk_docs=16, dtype=torch.float64, seed=3,
                         device="cpu")
    s.train(iter=3, viter=4, tol=0.0, printelbo=False)
    m = s.to_model()
    assert isinstance(m, tt.LDA)
    np.testing.assert_array_equal(host(m.state.beta), host(s.beta))
    np.testing.assert_array_equal(m.gamma, s.gamma[: s.M])
    np.testing.assert_allclose(m.topicdist(list(range(1, s.M + 1))),
                               s.gamma[: s.M] / s.gamma[: s.M].sum(1, keepdims=True),
                               rtol=1e-14)
    np.testing.assert_array_equal(m.topics, s.topics)
    assert m.elbo == s.elbo

    cp = port_packed(reader_packed(M=64, V=40, U=12, seed=13))
    c = pst.StreamingCTPF(cp, 3, batch_docs=32, chunk_docs=16, dtype=torch.float64, seed=3,
                          device="cpu")
    c.train(iter=3, viter=4, tol=0.0, printelbo=False)
    mc = c.to_model()
    np.testing.assert_array_equal(mc.alef, host(c.alef))
    np.testing.assert_array_equal(mc.gimel, c.gimel[: c.M])
    np.testing.assert_allclose(mc.scores, c.scores(), rtol=1e-12)
    assert len(mc.drecs[0]) > 0


def test_ranked_users_of_a_streaming_ctpf_match_jax():
    pk = reader_packed(M=64, V=40, U=12, seed=13)
    j, p = pair("StreamingCTPF", pk)
    j.train(iter=2, viter=4, tol=0.0, printelbo=False)
    p.train(iter=2, viter=4, tol=0.0, printelbo=False)
    np.testing.assert_allclose(p.scores(slice(0, 10)), j.scores(slice(0, 10)), rtol=1e-8)
    for d in range(1, p.M + 1):
        assert port_evaluate._ranked_users(p, d) == jax_evaluate._ranked_users(j, d), d
    held = [(d, 1) for d in (1, 5, 9)]
    assert port_evaluate.ranked_users(p, held) == {d: jax_evaluate._ranked_users(j, d)
                                                   for d, _ in held}


def test_errors(tmp_path):
    pk = port_packed(lda_packed())
    with pytest.raises(ValueError, match="dense"):
        pst.StreamingLDA(ppk.bucketize_packed(pk, 16), 3, device="cpu")
    with pytest.raises(ValueError, match="batch_docs must divide"):
        pst.StreamingLDA(pk, 3, batch_docs=40, chunk_docs=8, device="cpu")
    with pytest.raises(ValueError, match="chunk_docs"):
        pst.StreamingLDA(pk, 3, batch_docs=32, chunk_docs=12, device="cpu")
    s = pst.StreamingLDA(pk, 3, batch_docs=32, chunk_docs=16, device="cpu")
    for kappa in (0.5, 1.2):
        with pytest.raises(ValueError, match="kappa"):
            s.train_online(kappa=kappa, printelbo=False)
    with pytest.raises(ValueError, match="reader arrays"):
        pst.StreamingCTPF(pk, 3, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pst.StreamingLDA(pk, 3)          # the CUDA device unless asked
    path = str(tmp_path / "s.npz")
    s.save(path)
    with pytest.raises(ValueError, match="fingerprint"):
        pst.load(path, port_packed(lda_packed(seed=12345)), device="cpu")


_WORKER = textwrap.dedent("""
    import sys
    sys.path.insert(0, {root!r})
    import torch
    import topicmodelsvb_jl_torch as tt
    pk = tt.synth_packed_nsf_scale(M=96, V=50, mean_terms=10, seed=4, chunk_docs=16,
                                   pad_multiple=8)
    s = tt.StreamingLDA(pk, 3, batch_docs=32, chunk_docs=16, dtype=torch.float64, seed=3,
                        device="cpu")
    s.train(iter=100_000, tol=0.0, viter=5, printelbo=False, checkpoint_every=2,
            checkpoint_dir=sys.argv[1])
""")


def _done(ckpt_dir):
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(f for f in os.listdir(ckpt_dir)
                  if f.startswith("ckpt_iter") and not f.endswith(".tmp"))


def test_sigkilled_streaming_run_resumes_from_its_auto_checkpoint(tmp_path):
    """SIGKILL a streaming run once it has written two auto-checkpoints,
    resume from the last one and continue the uninterrupted trace."""
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
    pk = tt.synth_packed_nsf_scale(M=96, V=50, mean_terms=10, seed=4, chunk_docs=16,
                                   pad_multiple=8)
    ref = pst.StreamingLDA(pk, 3, batch_docs=32, chunk_docs=16, dtype=torch.float64, seed=3,
                           device="cpu")
    ref.train(iter=k_ckpt + 2, tol=0.0, viter=5, printelbo=False)
    resumed = pst.load(os.path.join(ckpt_dir, last), pk, device="cpu")
    assert resumed.trained_iters == k_ckpt
    resumed.train(iter=2, tol=0.0, viter=5, printelbo=False)
    assert_same(resumed, ref, 0, "SIGKILL resume")
