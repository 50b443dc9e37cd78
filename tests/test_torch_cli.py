"""The port's CLI (``python -m topicmodelsvb_jl_torch.train``) against the
JAX package's, on the CPU (``--device cpu``).

Counterparts of the fast tests of ``tests/test_cli.py``, then parity:
``_build_corpus`` gives both packages the same arrays byte for byte, and
a CLI run of the port started from the JAX CLI's init (the port model's
``_init_state`` patched, in the test only, to take the JAX state through
``convert.py``) follows the JAX CLI's ELBO trace to 1e-8 relative in f64
for every family and for streaming LDA.  Also the flops estimate of all
seven families against the JAX package's, the MFU figure, the profiler,
a checkpoint written by the port's CLI that the JAX package loads, two
gloo CLI processes, and a SIGKILL of a CLI process and the resume (the
port's counterpart of ``tests/test_faultinjection.py:41``).
"""

import dataclasses
import json
import os
import signal
import subprocess
import sys
import time
import types

import numpy as np
import pytest
import torch

import topicmodelsvb_jl_tpu as tm
import topicmodelsvb_jl_torch as tt
from topicmodelsvb_jl_tpu import api as jax_api
from topicmodelsvb_jl_tpu import streaming as jax_streaming
from topicmodelsvb_jl_tpu import train as jax_train
from topicmodelsvb_jl_tpu.ops.packing import pack_corpus as jax_pack
from topicmodelsvb_jl_torch import api as port_api
from topicmodelsvb_jl_torch import convert, engine
from topicmodelsvb_jl_torch import streaming as port_streaming
from topicmodelsvb_jl_torch import train as port_train
from topicmodelsvb_jl_torch.utils.config import TrainConfig
from torch_mp_worker import free_port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL_JAX = 1e-8
SMALL = ["--corpus", "synth", "--synth-m", "48", "--synth-v", "30", "--k", "3", "--iter", "3",
         "--checkelbo", "1", "--dtype", "float64", "--chunk-docs", "8", "--pad-multiple", "8",
         "--quiet", "--seed", "3"]


def run(argv):
    """The port's CLI on the CPU."""
    return port_train.run(list(argv) + ["--device", "cpu"])


# ── counterparts of tests/test_cli.py ──

def test_cli_trains_and_summarises(tmp_path):
    metrics = str(tmp_path / "m.jsonl")
    ckpt = str(tmp_path / "model.ckpt")
    summary = run([
        "--model", "lda", "--corpus", "synth", "--synth-m", "64",
        "--synth-v", "40", "--k", "3", "--iter", "5", "--checkelbo", "1",
        "--dtype", "float64", "--chunk-docs", "8", "--pad-multiple", "8",
        "--quiet", "--metrics", metrics, "--save", ckpt, "--seed", "3",
    ])
    assert summary["iterations"] == 5
    assert summary["model"] == "lda" and summary["K"] == 3
    assert summary["final_elbo"] is not None
    assert summary["docs_per_s"] > 0 and summary["tokens_per_s"] > 0
    assert summary["flops_per_step"] > 0 and summary["tflops_per_s"] > 0
    assert "mfu" not in summary   # the CPU has no peak
    rows = [json.loads(line) for line in open(metrics)]
    assert [r["k"] for r in rows] == [1, 2, 3, 4, 5]
    assert all(r["elbo"] is not None for r in rows)
    assert os.path.exists(ckpt)


def test_cli_checkpoint_loads_in_the_jax_package(tmp_path):
    """--save writes a checkpoint that JAX checkpoint.load reads, state
    and counters equal; its runtime knobs are all JAX RuntimeConfig fields."""
    ckpt = str(tmp_path / "model.ckpt")
    argv = ["--model", "lda", "--corpus", "synth", "--synth-m", "40", "--synth-v", "30",
            "--k", "3", "--iter", "3", "--dtype", "float64", "--chunk-docs", "8",
            "--pad-multiple", "8", "--quiet", "--seed", "2", "--elogtheta-f64",
            "--profile-dir", str(tmp_path / "prof"), "--save", ckpt]
    run(argv)
    corp = tm.synth_corpus(M=40, V=30, K=3, seed=2)
    jm = tm.checkpoint.load(ckpt, corp)
    pm = tt.load_checkpoint(ckpt, tt.synth_corpus(M=40, V=30, K=3, seed=2), device="cpu")
    assert jm.trained_iters == pm.trained_iters == 3
    assert jm.runtime.elogtheta_f64 and pm.runtime.elogtheta_f64
    assert jm.runtime.profile_dir is None and pm.runtime.profile_dir is None
    for f in ("alpha", "beta", "gamma", "Elogtheta"):
        np.testing.assert_array_equal(getattr(jm, f), getattr(pm, f))


def test_cli_packed_scale_corpus():
    summary = run([
        "--model", "lda", "--corpus", "nsf-scale", "--subset", "512",
        "--k", "4", "--iter", "2", "--checkelbo", "inf",
        "--chunk-docs", "64", "--quiet", "--no-pallas",
    ])
    assert summary["iterations"] == 2
    assert summary["M"] == 512 and summary["V"] == 25_319


def test_cli_ctm_runs():
    summary = run([
        "--model", "ctm", "--corpus", "synth", "--synth-m", "32",
        "--synth-v", "30", "--k", "3", "--iter", "2", "--checkelbo", "1",
        "--dtype", "float64", "--chunk-docs", "8", "--pad-multiple", "8",
        "--niter", "30", "--quiet",
    ])
    assert np.isfinite(summary["final_elbo"])


def test_cli_streaming_and_online():
    s = run([
        "--model", "lda", "--corpus", "synth", "--synth-m", "96",
        "--synth-v", "40", "--k", "3", "--iter", "3", "--checkelbo", "1",
        "--dtype", "float64", "--chunk-docs", "16", "--pad-multiple", "8",
        "--streaming", "--batch-docs", "48", "--quiet",
    ])
    assert s["mode"] == "streaming" and np.isfinite(s["final_elbo"])
    o = run([
        "--model", "lda", "--corpus", "synth", "--synth-m", "96",
        "--synth-v", "40", "--k", "3", "--iter", "2", "--checkelbo", "1",
        "--dtype", "float64", "--chunk-docs", "16", "--pad-multiple", "8",
        "--online", "--batch-docs", "48", "--tau0", "4", "--quiet",
    ])
    assert o["mode"] == "online" and np.isfinite(o["final_elbo"])


@pytest.mark.parametrize("model", ["ctm", "flda"])
def test_cli_streaming_ctm_and_flda(model):
    o = run([
        "--model", model, "--corpus", "synth", "--synth-m", "48",
        "--synth-v", "30", "--k", "3", "--iter", "3",
        "--checkelbo", "1", "--dtype", "float64", "--chunk-docs", "16",
        "--pad-multiple", "8", "--streaming", "--batch-docs", "48",
        "--quiet",
    ])
    assert o["mode"] == "streaming" and np.isfinite(o["final_elbo"])


def test_pick_stream_batch_divisibility():
    pick = port_train._pick_stream_batch
    for M_pad, want, n_dev in [(2048, 8192, 3), (2048, 8192, 1),
                               (1536, 8192, 3), (1024, 64, 4),
                               (120, 7, 5), (128, 4, 8)]:
        b = pick(M_pad, want, n_dev)
        if b:
            assert M_pad % b == 0 and b % n_dev == 0 and b <= want, (M_pad, want, n_dev, b)
    assert pick(2048, 8192, 3) == 0
    assert pick(1536, 8192, 3) == 1536


def test_pick_stream_batch_matches_bruteforce_and_jax():
    for M_pad in (1, 7, 36, 97, 120, 1024, 1536):
        for want in (1, 5, 64, 10_000):
            for n_dev in (1, 2, 3, 8):
                brute = max((b for b in range(1, M_pad + 1)
                             if M_pad % b == 0 and b % n_dev == 0 and b <= want), default=0)
                assert port_train._pick_stream_batch(M_pad, want, n_dev) == brute
    r = np.random.default_rng(5)
    for M_pad, want, n_dev in zip(r.integers(1, 200_000, 300), r.integers(1, 20_000, 300),
                                  r.integers(1, 9, 300)):
        args = (int(M_pad), int(want), int(n_dev))
        assert port_train._pick_stream_batch(*args) == jax_train._pick_stream_batch(*args)


def test_cli_hmtm_expands_condensed_corpus(capsys):
    s = run([
        "--model", "hmtm", "--corpus", "synth", "--synth-m", "24",
        "--synth-v", "30", "--k", "3", "--iter", "2", "--checkelbo", "1",
        "--dtype", "float64", "--chunk-docs", "8", "--pad-multiple", "8",
        "--quiet",
    ])
    assert s["model"] == "hmtm" and np.isfinite(s["final_elbo"])
    assert "expanding condensed corpus" in capsys.readouterr().out


def test_cli_round5_knobs(tmp_path):
    """--checkpoint-f16 and --elogtheta-f64 reach RuntimeConfig and give a
    working f32 run."""
    ck = str(tmp_path / "ck")
    s = run([
        "--model", "lda", "--corpus", "synth", "--synth-m", "32",
        "--synth-v", "30", "--k", "3", "--iter", "3", "--checkelbo", "1",
        "--chunk-docs", "8", "--pad-multiple", "8", "--quiet", "--seed", "3",
        "--checkpoint-every", "2", "--checkpoint-dir", ck,
        "--checkpoint-f16", "--elogtheta-f64",
    ])
    assert np.isfinite(s["final_elbo"])
    snaps = sorted(os.listdir(ck))
    assert snaps == ["ckpt_iter000002"]
    with np.load(os.path.join(ck, snaps[-1]), allow_pickle=False) as z:
        meta = json.loads(bytes(z["__meta__"]))
        assert meta["compress"] == "f16" and meta["runtime"]["elogtheta_f64"] is True
        assert any(z[k].dtype == np.float16 for k in z.files if k.startswith("leaf_"))


def _sparse_packed_dir(tmp_path):
    """tests/test_cli.py's trim case: a packed corpus using every 5th id."""
    from topicmodelsvb_jl_tpu.ops.packing import pack_corpus, save_packed

    corp = tm.synth_corpus(M=32, V=30, K=3, seed=3, mean_terms=10)
    dense = pack_corpus(corp, pad_multiple=8, docs_multiple=16)
    live = dense.counts > 0
    sparse = dataclasses.replace(
        dense, terms=np.where(live, dense.terms * 5 + 1, 0).astype(np.int32), V=30 * 5 + 1)
    pdir = str(tmp_path / "p")
    save_packed(pdir, sparse)
    return pdir, sparse


def test_cli_trim_packed(tmp_path):
    pdir, sparse = _sparse_packed_dir(tmp_path)
    sdir = str(tmp_path / "s")
    s = run([
        "--model", "lda", "--packed-dir", pdir, "--trim-packed",
        "--k", "3", "--iter", "2", "--checkelbo", "1", "--quiet",
        "--chunk-docs", "8", "--streaming", "--batch-docs", "16",
        "--state-dir", sdir, "--json",
    ])
    assert np.isfinite(s["final_elbo"])
    used = np.load(os.path.join(sdir, "vocab_ids.npy"))
    assert s["V"] == len(used) < sparse.V


def test_cli_refusals(monkeypatch):
    """The JAX CLI's refusals, and the card's: --no-pallas, checked before
    any corpus is built; float64 on a CUDA device now passes the dtype
    gate for every model (CTPF and HMTM too) before any corpus is built."""
    with pytest.raises(SystemExit, match="metrics"):
        run(SMALL + ["--model", "lda", "--streaming", "--metrics", "x.jsonl"])
    with pytest.raises(SystemExit, match="state-dir"):
        run(SMALL + ["--model", "lda", "--state-dir", "s"])
    with pytest.raises(SystemExit, match="identify"):
        run(SMALL + ["--model", "lda", "--identify"])
    with pytest.raises(SystemExit, match="need --corpus"):
        run(["--model", "lda", "--k", "3"])
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            port_train.run(SMALL + ["--model", "lda"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(SystemExit, match="no plain E-step path"):
        port_train.run(SMALL + ["--model", "lda", "--no-pallas"])
    from topicmodelsvb_jl_torch.kernels import _build

    real = _build.check_dtype

    class Admitted(Exception):
        pass

    def admitted(*a, **k):
        real(*a, **k)
        raise Admitted

    monkeypatch.setattr(_build, "check_dtype", admitted)
    for model in ("ctpf", "hmtm"):
        with pytest.raises(Admitted):
            port_train.run(SMALL + ["--model", model])


# ── identical inputs ──

def _corpora_equal(a, b):
    assert len(a.docs) == len(b.docs)
    for x, y in zip(a.docs, b.docs):
        for f in ("terms", "counts", "readers", "ratings"):
            assert list(getattr(x, f)) == list(getattr(y, f)), f
        assert x.stamp == y.stamp and x.title == y.title
    assert dict(a.vocab) == dict(b.vocab) and dict(a.users) == dict(b.users)


def _packed_equal(a, b):
    for f in dataclasses.fields(b):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(y, np.ndarray):
            assert x.dtype == y.dtype and x.shape == y.shape, f.name
            assert np.ascontiguousarray(x).tobytes() == np.ascontiguousarray(y).tobytes(), f.name
        elif f.name != "segments":
            assert x == y, f.name


def _build_both(argv):
    argv = ["--model", "lda", "--k", "3"] + argv
    return (jax_train._build_corpus(jax_train.build_parser().parse_args(argv)),
            port_train._build_corpus(port_train.build_parser().parse_args(argv)))


def test_build_corpus_synth_and_docfile_identical(tmp_path):
    j, p = _build_both(["--corpus", "synth", "--synth-m", "40", "--synth-v", "30",
                        "--synth-u", "9", "--synth-slices", "3", "--seed", "4"])
    _corpora_equal(j, p)
    _packed_equal(jax_pack(j, pad_multiple=8, docs_multiple=8, with_readers=True),
                  tt.pack_corpus(p, pad_multiple=8, docs_multiple=8, with_readers=True))
    files = {n: str(tmp_path / f"{n}.txt") for n in ("docs", "vocab", "users", "titles")}
    tt.writecorp(p, docfile=files["docs"], vocabfile=files["vocab"], userfile=files["users"],
                 titlefile=files["titles"], counts=True, readers=True, ratings=True,
                 stamps=True)
    j, p = _build_both(["--docfile", files["docs"], "--vocabfile", files["vocab"],
                        "--userfile", files["users"], "--titlefile", files["titles"],
                        "--counts", "--readers", "--ratings", "--stamps"])
    _corpora_equal(j, p)
    _packed_equal(jax_pack(j, pad_multiple=8, docs_multiple=8, with_readers=True),
                  tt.pack_corpus(p, pad_multiple=8, docs_multiple=8, with_readers=True))


def test_build_corpus_packed_identical(tmp_path):
    j, p = _build_both(["--corpus", "nsf-scale", "--subset", "300", "--chunk-docs", "16"])
    _packed_equal(j, p)
    pdir, _ = _sparse_packed_dir(tmp_path)
    j, p = _build_both(["--packed-dir", pdir, "--trim-packed", "--json",
                        "--checkpoint-dir", str(tmp_path / "ck")])
    _packed_equal(j, p)
    assert j.V == p.V < 151


# ── the same trace from the same init ──

def _state_arrays(state) -> dict:
    return {k: np.array(v) for k, v in state._asdict().items()}


def _snapshot_stream(m) -> types.SimpleNamespace:
    """A JAX streaming model's globals, host state and counters, copied."""
    out = types.SimpleNamespace()
    for n in m._globals:
        setattr(out, n, np.array(getattr(m, n)))
    for n in m._doc_state:
        setattr(out, n, np.array(getattr(m, n)))
    for n in m._counters:
        setattr(out, n, getattr(m, n))
    return out


FAMILIES = {"lda": ("LDA", []), "flda": ("fLDA", []), "ctm": ("CTM", []),
            "ctpf": ("CTPF", ["--synth-u", "12"]), "hmtm": ("HMTM", []),
            "dtm": ("DTM", ["--synth-slices", "3"])}


@pytest.mark.parametrize("model", list(FAMILIES) + ["streaming-lda"])
def test_cli_follows_the_jax_cli_from_its_init(monkeypatch, tmp_path, model):
    """In f64, from the JAX CLI's init, the port's CLI gives the JAX CLI's
    ELBO trace to 1e-8 relative, and the same summary keys.  One device
    each (``--n-devices 1``: the JAX tests' CPU has 8 virtual devices)."""
    streaming = model == "streaming-lda"
    family = "lda" if streaming else model
    argv = SMALL + ["--model", family, "--n-devices", "1"] + (
        ["--streaming", "--batch-docs", "16"] if streaming else FAMILIES[family][1])
    seen = []
    if streaming:
        jcls, pcls = jax_streaming.StreamingLDA, port_streaming.StreamingLDA
        j_init, p_init = jcls.__init__, pcls.__init__

        def jax_init(self, *a, **k):
            j_init(self, *a, **k)
            seen.append((self, _snapshot_stream(self)))

        def port_init(self, *a, **k):
            p_init(self, *a, **k)
            convert.streaming_from(self, seen[0][1])
            seen.append((self, None))

        monkeypatch.setattr(jcls, "__init__", jax_init)
        monkeypatch.setattr(pcls, "__init__", port_init)
    else:
        name = FAMILIES[family][0]
        jcls, pcls = getattr(jax_api, name), getattr(port_api, name)
        j_init, p_state = jcls.__init__, pcls._init_state

        def jax_init(self, *a, **k):
            j_init(self, *a, **k)
            seen.append((self, _state_arrays(self.state)))

        def port_state(self):
            p_state(self)
            self.state = convert.state_for(self, seen[0][1])
            seen.append((self, None))

        monkeypatch.setattr(jcls, "__init__", jax_init)
        monkeypatch.setattr(pcls, "_init_state", port_state)
        jm_metrics, pm_metrics = str(tmp_path / "j.jsonl"), str(tmp_path / "p.jsonl")
    js = jax_train.run(argv + ([] if streaming else ["--metrics", jm_metrics]))
    ps = run(argv + ([] if streaming else ["--metrics", pm_metrics]))
    assert set(ps) == set(js) - {"mfu"}   # the JAX package's peak is a TPU's
    assert len(seen) == 2
    if streaming:
        jt, pt = [t[1] for t in seen[0][0].trace], [t[1] for t in seen[1][0].trace]
    else:
        jt = [json.loads(r)["elbo"] for r in open(jm_metrics)]
        pt = [json.loads(r)["elbo"] for r in open(pm_metrics)]
        assert ps["flops_per_step"] == js["flops_per_step"]
    assert len(pt) == len(jt) == 3
    np.testing.assert_allclose(pt, jt, rtol=RTOL_JAX)
    assert ps["final_elbo"] == pytest.approx(js["final_elbo"], rel=RTOL_JAX)
    for k in ("model", "K", "M", "V") + (("mode", "batch_docs") if streaming else ()):
        assert ps[k] == js[k], k


# ── flops, MFU and the profiler ──

def test_flops_per_step_equals_the_jax_package_on_every_family():
    from topicmodelsvb_jl_tpu.datasets import synth_packed_nsf_scale as jax_synth_packed
    from topicmodelsvb_jl_tpu.ops.packing import unit_counts as jax_unit
    from topicmodelsvb_jl_tpu.parallel.mesh import make_mesh
    from topicmodelsvb_jl_tpu.utils.config import RuntimeConfig as JaxRuntimeConfig
    from topicmodelsvb_jl_torch.ops.packing import unit_counts as port_unit

    corp = dict(M=60, V=40, K=3, U=15, seed=6, mean_terms=9, n_slices=3, drift=0.05)
    jc, pc = tm.synth_corpus(**corp), tt.synth_corpus(**corp)
    kw = dict(M=90, V=70, mean_terms=12, seed=2, chunk_docs=16)
    jp, pp = jax_synth_packed(**kw), tt.synth_packed_nsf_scale(**kw)
    cases = [("LDA", jp, pp), ("fLDA", jp, pp), ("CTM", jp, pp), ("fCTM", jp, pp),
             ("CTPF", jc, pc), ("HMTM", jax_unit(jp), port_unit(pp)),
             ("DTM", jc, pc)]
    K = 5
    for name, jcorp, pcorp in cases:
        extra = {"delta": 1.0} if name == "DTM" else {}
        jm = getattr(tm, name)(jcorp, K, runtime=JaxRuntimeConfig(chunk_docs=16),
                               mesh=make_mesh(n_devices=1), seed=1, **extra)
        pm = getattr(tt, name)(pcorp, K, runtime=tt.RuntimeConfig(chunk_docs=16),
                               device="cpu", seed=1, **extra)
        assert pm._flops_per_step() == jm._flops_per_step() > 0, name
        for m in (jm, pm):
            m._cfg, m._cgiter = TrainConfig(viter=7), 5
        assert pm._flops_per_step() == jm._flops_per_step(), name


def _tiny(**rt):
    return tt.LDA(tt.synth_packed_nsf_scale(M=40, V=30, mean_terms=8, seed=1, chunk_docs=8),
                  3, tt.RuntimeConfig(chunk_docs=8, **rt), device="cpu", seed=2)


def test_summary_mfu_only_with_a_peak():
    m = _tiny(peak_flops=1e9).train(iter=3, checkelbo=1, printelbo=False)
    s = m.trainer.summary()
    assert s["flops_per_step"] == m._flops_per_step()
    assert s["mfu"] == pytest.approx(s["flops_per_step"] / s["mean_step_s"] / 1e9)
    assert s["tflops_per_s"] == pytest.approx(s["flops_per_step"] / s["mean_step_s"] / 1e12)
    for rt in ({}, {"peak_flops": 0.0}):
        s = _tiny(**rt).train(iter=2, checkelbo=1, printelbo=False).trainer.summary()
        assert "mfu" not in s and s["tflops_per_s"] > 0


def test_device_peak_flops_from_the_card(monkeypatch):
    """SMs × 128 f32 lanes × 2 × the max SM clock nvidia-smi gives: 66.9
    TFLOP/s for an H100 SXM's 132 SMs at 1980 MHz; 0 on the CPU."""
    assert engine.device_peak_flops("cpu") == 0.0
    props = types.SimpleNamespace(multi_processor_count=132, uuid="abc")
    calls = []

    def smi(cmd, **kw):
        calls.append(cmd)
        return types.SimpleNamespace(stdout="1980\n")

    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda i: props)
    monkeypatch.setattr(engine.subprocess, "run", smi)
    engine._cuda_peak_flops.cache_clear()
    try:
        assert engine.device_peak_flops(torch.device("cuda", 0)) == 132 * 128 * 2 * 1.98e9
        assert calls[0][:3] == ["nvidia-smi", "-i", "GPU-abc"]
        assert "--query-gpu=clocks.max.sm" in calls[0]
    finally:
        engine._cuda_peak_flops.cache_clear()


def _trace_events(d):
    files = os.listdir(d)
    assert len(files) == 1
    with open(os.path.join(d, files[0])) as f:
        return files[0], json.load(f)["traceEvents"]


def test_profile_dir_writes_a_trace_of_cavi_steps(tmp_path):
    prof = str(tmp_path / "prof")
    run(SMALL + ["--model", "lda", "--iter", "6", "--profile-dir", prof])
    name, events = _trace_events(prof)
    assert name == "trace_iter000002-000004.json"   # profile_steps = 3 from k0 + 2
    assert sum(e.get("name") == "cavi_step" for e in events) == 3
    # a run that stops before profile_steps steps still writes its capture
    prof2 = str(tmp_path / "prof2")
    m = _tiny(profile_dir=prof2, profile_steps=5).train(iter=3, checkelbo=1, printelbo=False)
    name, events = _trace_events(prof2)
    assert name == "trace_iter000002-000003.json" and len(m.trainer.trace) == 3
    assert sum(e.get("name") == "cavi_step" for e in events) == 2


def test_a_run_that_raises_mid_profile_leaves_no_profiler(tmp_path):
    m = _tiny(profile_dir=str(tmp_path / "prof"))
    m.train(iter=1, checkelbo=1, printelbo=False)
    trainer = m._build_trainer(m._cfg)
    step, n = trainer.step_fn, [0]

    def failing(state, *data):
        n[0] += 1
        if n[0] == 3:
            raise RuntimeError("step failed")
        return step(state, *data)

    trainer.step_fn = failing
    with pytest.raises(RuntimeError, match="step failed"):
        trainer.train(m.state, dataclasses.replace(m._cfg, iter=5))
    assert not torch._C._autograd._profiler_enabled()
    assert not os.path.exists(tmp_path / "prof")   # a failed capture writes nothing


# ── processes ──

def _cli(argv, **kw):
    return subprocess.Popen([sys.executable, "-m", "topicmodelsvb_jl_torch.train", *argv],
                            cwd=ROOT, env=dict(os.environ, OMP_NUM_THREADS="1"), text=True,
                            **kw)


def _cli_group(argv, world, timeout=180):
    """``world`` CLI processes of one gloo group on a free port: their
    (stdout, stderr) once all exit 0.  A rank that fails ends the attempt
    (its peers would wait on the rendezvous) and the group starts again on
    a new port, up to 3 times: the port can be taken before rank 0 binds."""
    for attempt in range(3):
        port = free_port()
        procs = [_cli(argv + ["--coordinator", f"localhost:{port}", "--num-processes",
                              str(world), "--process-id", str(r)],
                      stdout=subprocess.PIPE, stderr=subprocess.PIPE) for r in range(world)]
        t0 = time.time()
        while (any(p.poll() is None for p in procs) and time.time() - t0 < timeout
               and not any(p.poll() not in (None, 0) for p in procs)):
            time.sleep(0.05)
        ok = all(p.poll() == 0 for p in procs)
        for p in procs:
            if p.poll() is None:
                p.kill()
        outs = [p.communicate(timeout=60) for p in procs]
        if ok:
            return outs
    raise AssertionError([o[1][-3000:] for o in outs])


def test_two_gloo_cli_processes_agree():
    """--coordinator on two gloo processes: one sharded model, equal
    summaries; they follow the one-process run to 1e-8."""
    argv = SMALL + ["--model", "lda", "--json"]
    one = run(argv)
    outs = _cli_group(argv + ["--device", "cpu"], 2)
    sums = [json.loads(o[0].strip().splitlines()[-1]) for o in outs]
    for k in ("iterations", "final_elbo", "flops_per_step", "M", "V", "K"):
        assert sums[0][k] == sums[1][k], k
    assert sums[0]["final_elbo"] == pytest.approx(one["final_elbo"], rel=RTOL_JAX)


def test_sigkill_of_a_cli_process_and_resume(tmp_path):
    """tests/test_faultinjection.py:41 through the port's CLI: a CLI
    process checkpointing every iteration is killed by SIGKILL after two
    checkpoints; a checkpoint.load resume continues the uninterrupted
    trace to 1e-10, with the global iteration numbers."""
    ckpt_dir = str(tmp_path / "ckpts")
    corpus = ["--corpus", "synth", "--synth-m", "64", "--synth-v", "40", "--k", "3",
              "--dtype", "float64", "--chunk-docs", "8", "--pad-multiple", "8", "--seed", "9"]
    proc = _cli(corpus + ["--model", "lda", "--iter", "100000", "--tol", "0", "--quiet",
                          "--checkpoint-every", "1", "--checkpoint-dir", ckpt_dir,
                          "--device", "cpu"],
                stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)

    def done():
        if not os.path.isdir(ckpt_dir):
            return []
        return sorted(f for f in os.listdir(ckpt_dir)
                      if f.startswith("ckpt_iter") and not f.endswith(".tmp"))

    try:
        t0 = time.time()
        while len(done()) < 2:
            assert proc.poll() is None, proc.stderr.read()
            assert time.time() - t0 < 120, "the CLI wrote no checkpoints in 120 s"
            time.sleep(0.02)
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    assert proc.returncode == -signal.SIGKILL
    last = done()[-1]
    k_ckpt = int(last.replace("ckpt_iter", ""))
    assert k_ckpt >= 2
    total = k_ckpt + 4
    corp = tt.synth_corpus(M=64, V=40, K=3, seed=9)
    rt = tt.RuntimeConfig(chunk_docs=8, dtype="float64", pad_multiple=8)
    ref = tt.LDA(corp, 3, rt, device="cpu", seed=9)
    ref.train(iter=total, tol=0.0, checkelbo=1, printelbo=False)
    resumed = tt.load_checkpoint(os.path.join(ckpt_dir, last), corp, device="cpu")
    assert resumed.trained_iters == k_ckpt
    resumed.train(iter=total - k_ckpt, tol=0.0, checkelbo=1, printelbo=False)
    np.testing.assert_allclose([r.elbo for r in resumed.trainer.trace],
                               [r.elbo for r in ref.trainer.trace[k_ckpt:]], rtol=1e-10)
    assert [r.k for r in resumed.trainer.trace] == list(range(k_ckpt + 1, total + 1))


def test_python_m_entry_prints_the_summary_last():
    p = _cli(SMALL + ["--model", "flda", "--device", "cpu"], stdout=subprocess.PIPE,
             stderr=subprocess.PIPE)
    out, err = p.communicate(timeout=300)
    assert p.returncode == 0, err[-3000:]
    s = json.loads(out.strip().splitlines()[-1])
    assert s["model"] == "flda" and s["iterations"] == 3 and np.isfinite(s["final_elbo"])
