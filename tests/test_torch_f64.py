"""Float64 on the card: the dtype gate, its callers, and the float64 plain
versions of lda_estep, flda_estep, lda_elbo_tok and scatter_rows against
the JAX package, on the CPU (those of ctpf_estep, hmtm_estep, hmtm_logz
and the three pass modes: tests/test_torch_f64_families.py).

* The gate (``kernels._build.check_dtype``) over the seven families,
  three dtypes, both device kinds and the mesh axes each family runs on:
  every kernel has a float64 mode, so float32 and float64 pass on both
  devices and float16 is refused on CUDA.  It is called with a
  ``torch.device("cuda")`` object on a machine without a card, under a
  mode that fails on any torch call: it allocates nothing.
* The CLI and ``load_checkpoint`` ask the gate before anything is built.
* ``lda_estep_ref`` and ``flda_estep_ref`` in float64 against the JAX
  package's Pallas kernels run in interpret mode in float64 (x64 enabled,
  as tests/conftest.py sets it), and ``lda_elbo_tok_ref`` against the
  token terms of the JAX package's XLA bound in float64 (its Pallas
  kernel takes ``log`` from float32 bits, ``alog_bits``): rtol 1e-10.
  ``scatter_rows_ref`` in float64 against the JAX ``count_scatter`` is
  tests/test_torch_scatter.py::test_plain_matches_jax_count_scatter_in_f64
  (rtol 1e-12); here, the plan's scratch keyed by dtype.
* The MFU figure's peak in float64 (64 FP64 lanes an SM), and
  ``RuntimeConfig.vocab_axis`` through checkpoints of both packages.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.special import digamma

import topicmodelsvb_jl_tpu as tm
from topicmodelsvb_jl_tpu.kernels.flda_estep import flda_estep as jax_flda_estep
from topicmodelsvb_jl_tpu.kernels.lda_estep import lda_estep as jax_lda_estep
from topicmodelsvb_jl_tpu.models.lda import _phi as jax_phi
from topicmodelsvb_jl_tpu.parallel.mesh import make_mesh
from topicmodelsvb_jl_tpu.utils.config import RuntimeConfig as JaxRuntimeConfig
from topicmodelsvb_jl_tpu.utils.numerics import asoftmax, categorical_entropy
import topicmodelsvb_jl_torch as tt
from topicmodelsvb_jl_torch import api
from topicmodelsvb_jl_torch import engine
from topicmodelsvb_jl_torch import train as port_train
from topicmodelsvb_jl_torch.kernels import _build
from topicmodelsvb_jl_torch.kernels.flda_estep import flda_estep, flda_estep_ref
from topicmodelsvb_jl_torch.kernels.lda_elbo import lda_elbo_tok, lda_elbo_tok_ref
from topicmodelsvb_jl_torch.kernels.lda_estep import lda_estep, lda_estep_ref
from topicmodelsvb_jl_torch.kernels.scatter_rows import build_plan
from topicmodelsvb_jl_torch.utils.numerics import EPSILON

KP = 128
RTOL = 1e-10   # float64 plain version against the JAX package in float64


# ── the gate ──

# every family's mesh axes (None: no mesh), as the JAX package has them
AXES = {"LDA": (None, "data", "vocab", "routed", "seq"),
        "fLDA": (None, "data", "vocab", "seq"),
        "CTM": (None, "data", "vocab", "seq"),
        "fCTM": (None, "data", "vocab", "seq"),
        "CTPF": (None, "data", "vocab", "user", "seq"),
        "DTM": (None, "data", "vocab"),
        "HMTM": (None, "data", "vocab")}
GATE_CASES = [(fam, ax) for fam, axes in AXES.items() for ax in axes]


class _NoTorchCalls(torch.overrides.TorchFunctionMode):
    """Fails on any torch function call: the gate must make no tensor."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        raise AssertionError(f"the gate called {func}")


@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.float16])
@pytest.mark.parametrize("fam,axis", GATE_CASES)
def test_gate(fam, axis, dtype, device):
    dev = torch.device(device)
    axes = () if axis is None else (axis,)
    with _NoTorchCalls():
        if dev.type == "cuda" and dtype == torch.float16:
            with pytest.raises(TypeError, match=f"{fam} in float16 on CUDA"):
                _build.check_dtype(fam, dtype, dev, axes)
        else:
            _build.check_dtype(fam, dtype, dev, axes)


def test_every_kernel_has_a_float64_mode():
    kernels = {k for ks in _build.FAMILY_KERNELS.values() for k in ks}
    kernels |= {k for ks in _build.AXIS_KERNELS.values() for k in ks}
    assert len(kernels) == 10 and _build.FLOAT64_KERNELS == kernels


def test_gate_rejects_axes_and_dtypes_it_does_not_know():
    with pytest.raises(ValueError, match="DTM has no seq axis"):
        _build.check_dtype("DTM", "float32", "cpu", ("seq",))
    with pytest.raises(ValueError, match="HMTM has no routed axis"):
        _build.check_dtype("HMTM", "float64", "cuda", ("routed",))
    with pytest.raises(ValueError, match="unknown model family"):
        _build.check_dtype("PLSA", "float32", "cpu")
    with pytest.raises(TypeError, match="float16 on CUDA"):
        _build.check_dtype("LDA", torch.float16, "cuda:0")
    _build.check_dtype("LDA", torch.float16, "cpu")   # the plain versions take any dtype
    # the families' kernels as the gate counts them
    assert _build.kernels_of("CTM", ("seq",)) == ("lda_elbo_tok", "scatter_rows")
    assert _build.kernels_of("fLDA", ("data", "seq"))[-1] == "flda_estep_pass"


def test_models_ask_the_gate_before_allocating(monkeypatch):
    """The api constructors, the streaming constructors and a step on a
    token-splitting axis refuse float16 CTPF, HMTM and seq LDA on CUDA
    before touching the device (its availability is faked here); float64
    passes the gate there and goes on to build."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    pk = tt.synth_packed_nsf_scale(M=64, V=40, mean_terms=8, seed=2, chunk_docs=32)
    rt = tt.RuntimeConfig(chunk_docs=32, dtype="float16")
    for cls in (tt.CTPF, tt.HMTM):
        with pytest.raises(TypeError, match=f"{cls.__name__} in float16 on CUDA"):
            cls(pk, 3, rt, device="cuda")
    from topicmodelsvb_jl_torch.ops.packing import unit_counts

    with pytest.raises(TypeError, match="HMTM in float16 on CUDA"):
        tt.StreamingHMTM(unit_counts(pk), 3, batch_docs=32, chunk_docs=32,
                         dtype="float16", device="cuda")
    from topicmodelsvb_jl_torch.models import lda as lda_mod

    step = lda_mod.make_step(pk, 3, 2, 1e-3, 10, 1e-3, 32, "cpu", seq_axis="seq")
    # stand-ins for a state on the card: the step reads its dtype and
    # device before anything else, so float64 gets past the gate and
    # fails only on the stand-in itself
    st = lambda dt: types.SimpleNamespace(beta=types.SimpleNamespace(
        dtype=dt, device=torch.device("cuda")))
    with pytest.raises(TypeError, match="LDA in float16 on CUDA"):
        step(st(torch.float16), None, None, None, None)
    with pytest.raises(Exception) as past:
        step(st(torch.float64), None, None, None, None)
    assert "on CUDA" not in str(past.value)


class _Admitted(Exception):
    pass


def test_cli_and_checkpoint_load_ask_the_gate(monkeypatch, tmp_path):
    """--dtype float64 reaches the gate with the model's family and the
    CUDA device before any corpus is built; load_checkpoint reaches it
    through the model's constructor, before anything is allocated: float64
    LDA, DTM and CTPF checkpoints are admitted for CUDA."""
    asked = []

    def recording(family, dtype, device, axes=()):
        asked.append((family, str(dtype), torch.device(device).type))
        raise _Admitted

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(_build, "check_dtype", recording)
    for model, fam in (("lda", "LDA"), ("dtm", "DTM"), ("ctpf", "CTPF")):
        with pytest.raises(_Admitted):
            port_train.run(["--model", model, "--corpus", "synth", "--k", "3",
                            "--dtype", "float64"])
        assert asked[-1] == (fam, "float64", "cuda")
    monkeypatch.undo()

    corp = tt.synth_corpus(M=40, V=30, K=3, seed=4, n_slices=3, mean_tokens=15,
                           mean_terms=8)
    rt = tt.RuntimeConfig(chunk_docs=16, dtype="float64")
    real = api.check_dtype

    def then_stop(family, dtype, device, axes=()):
        real(family, dtype, device, axes)
        raise _Admitted

    for cls, kw in ((tt.LDA, {}), (tt.DTM, {"delta": 1.0}), (tt.CTPF, {})):
        tt.save_checkpoint(str(tmp_path / f"{cls.__name__}.npz"),
                           cls(corp, 3, runtime=rt, device="cpu", **kw))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(api, "check_dtype", then_stop)
    for name in ("LDA", "DTM"):
        with pytest.raises(_Admitted):
            tt.load_checkpoint(str(tmp_path / f"{name}.npz"), corp, device=torch.device("cuda"))
    with pytest.raises(_Admitted):
        tt.load_checkpoint(str(tmp_path / "CTPF.npz"), corp, device="cuda")


# ── the float64 plain versions against the JAX package ──

def _inputs(K, B=16, L=24, V=40, seed=3):
    """One chunk of documents with a warm state, in float64; the last 3
    are padding."""
    r = np.random.default_rng(seed)
    beta = r.dirichlet(np.ones(V), size=K)                      # [K, V]
    terms = r.integers(0, V, size=(B, L)).astype(np.int32)
    counts = (1.0 + r.poisson(0.4, size=(B, L)))
    valid = np.arange(L)[None, :] < r.integers(3, L, size=B)[:, None]
    counts *= valid
    terms *= valid
    doc_mask = np.ones(B)
    doc_mask[-3:] = 0.0
    counts[-3:] = 0.0
    alpha = r.uniform(0.2, 1.5, K)
    gamma = alpha + r.uniform(0.1, 5.0, size=(B, K))
    El = digamma(gamma) - digamma(gamma.sum(-1, keepdims=True))
    return dict(beta=beta, beta_old=r.dirichlet(np.ones(V), size=K), kappa=r.dirichlet(np.ones(V)),
                terms=terms, counts=counts, doc_mask=doc_mask, alpha=alpha, gamma=gamma, El=El,
                El_old=El + r.normal(0, 0.05, size=(B, K)),
                tau=r.uniform(0.1, 0.9, size=(B, L)), tau_old=r.uniform(0.1, 0.9, size=(B, L)))


def _padk(a, v=0.0):
    a = jnp.asarray(a)
    return jnp.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, KP - a.shape[-1])], constant_values=v)


def _t(a):
    return torch.tensor(np.asarray(a))


def _assert_close(pairs):
    for name, a, b in pairs:
        a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        assert a.dtype == np.float64, name
        np.testing.assert_allclose(a, np.asarray(b), rtol=RTOL, atol=1e-14, err_msg=name)


@pytest.mark.parametrize("K", [7, 16])
def test_lda_estep_ref_f64_matches_jax(K):
    x = _inputs(K)
    vtol = 1.0 / K**2
    betaT = x["beta"].T + EPSILON
    want = jax_lda_estep(_padk(betaT)[jnp.asarray(x["terms"])], jnp.asarray(x["counts"]),
                         jnp.asarray(x["doc_mask"]), _padk(x["alpha"]), _padk(x["gamma"]),
                         _padk(x["El"]), _padk(x["El_old"]), viter=6, vtol=vtol, n_topics=K,
                         interpret=True)
    assert want[0].dtype == jnp.float64
    args = tuple(_t(x[k]) for k in ("terms", "counts", "doc_mask", "alpha", "gamma", "El",
                                    "El_old"))
    got = lda_estep_ref(_t(betaT), *args, viter=6, vtol=vtol)
    _assert_close([(n, a, np.asarray(b)[..., :K])
                   for n, a, b in zip(("gamma", "El", "El_old", "w"), got, want)])
    # the f64 Elogtheta channel is the identity on a float64 state
    assert all(torch.equal(a, b) for a, b in zip(
        lda_estep_ref(_t(betaT), *args, viter=6, vtol=vtol, elogtheta_f64=True), got))
    # on the CPU the wrapper is the plain version, and counts no launch
    n0 = (lda_estep.launches, lda_estep.launches_double)
    assert all(torch.equal(a, b)
               for a, b in zip(lda_estep(_t(betaT), *args, viter=6, vtol=vtol), got))
    assert (lda_estep.launches, lda_estep.launches_double) == n0


@pytest.mark.parametrize("K", [7, 16])
def test_flda_estep_ref_f64_matches_jax(K):
    """Padded to Kp = 128 by the JAX package's conventions (log-beta and
    alpha pads 0, Elogtheta pads -1e30)."""
    x = _inputs(K, seed=5)
    vtol = 1.0 / K**2
    lbT = np.log(x["beta"].T + EPSILON)
    want = jax_flda_estep(
        _padk(lbT)[jnp.asarray(x["terms"])], jnp.asarray(x["kappa"][x["terms"]]),
        jnp.asarray(x["counts"]), jnp.asarray(x["doc_mask"]), _padk(x["alpha"]),
        jnp.asarray(0.6), _padk(x["gamma"]), _padk(x["El"], -1e30), _padk(x["El_old"], -1e30),
        jnp.asarray(x["tau"]), jnp.asarray(x["tau_old"]), viter=6, vtol=vtol, n_topics=K,
        interpret=True)
    assert want[0].dtype == jnp.float64
    args = (_t(lbT), _t(x["kappa"]), *(_t(x[k]) for k in ("terms", "counts", "doc_mask",
                                                          "alpha")),
            torch.tensor(0.6, dtype=torch.float64),
            *(_t(x[k]) for k in ("gamma", "El", "El_old", "tau", "tau_old")))
    got = flda_estep_ref(*args, viter=6, vtol=vtol)
    w = got[5]
    _assert_close([("gamma", got[0], np.asarray(want[0])[:, :K]),
                   ("El", got[1], np.asarray(want[1])[:, :K]),
                   ("El_old", got[2], np.asarray(want[2])[:, :K]),
                   ("tau", got[3], want[3]), ("tau_old", got[4], want[4]),
                   ("w_beta", w[..., :K], np.asarray(want[5])[..., :K]),
                   ("w_kappa", w[..., K], want[6])])
    assert all(torch.equal(a, b) for a, b in zip(
        flda_estep_ref(*args, viter=6, vtol=vtol, elogtheta_f64=True), got))
    n0 = (flda_estep.launches, flda_estep.launches_double)
    assert all(torch.equal(a, b) for a, b in zip(flda_estep(*args, viter=6, vtol=vtol), got))
    assert (flda_estep.launches, flda_estep.launches_double) == n0


@pytest.mark.parametrize("K", [7, 16])
def test_lda_elbo_tok_ref_f64_matches_jax(K):
    """The token terms Elogpz + Elogpw − Elogqz of the JAX package's XLA
    bound (models/lda.py make_elbo's scan_body) in float64, phi from
    (beta_old, El_old)."""
    x = _inputs(K, seed=7)
    lbo = jnp.log(jnp.asarray(x["beta_old"].T + EPSILON))
    lb = jnp.log(jnp.asarray(x["beta"].T + EPSILON))
    t, c, dm = (jnp.asarray(x[k]) for k in ("terms", "counts", "doc_mask"))
    el, elo = jnp.asarray(x["El"]), jnp.asarray(x["El_old"])
    p = jax_phi(lbo[t], elo, softmax=asoftmax)
    e_pz = jnp.sum(jnp.einsum("bl,blk->bk", c, p) * el, -1)
    e_pw = jnp.sum(p * lb[t] * c[..., None], axis=(1, 2))
    e_qz = jnp.sum(categorical_entropy(p) * c, axis=-1)
    want = float(jnp.sum(dm * (e_pz + e_pw + e_qz)))
    boT = x["beta_old"].T + EPSILON
    g2T = boT * (np.log(x["beta"].T + EPSILON) - np.log(boT))
    args = (_t(boT), _t(g2T), *(_t(x[k]) for k in ("terms", "counts", "doc_mask", "El",
                                                   "El_old")))
    got = lda_elbo_tok_ref(*args)
    assert got.dtype == torch.float64
    assert abs(float(got) - want) <= RTOL * abs(want), (float(got), want)
    n0 = (lda_elbo_tok.launches, lda_elbo_tok.launches_double)
    assert torch.equal(lda_elbo_tok(*args), got)
    assert (lda_elbo_tok.launches, lda_elbo_tok.launches_double) == n0


def test_scatter_plan_scratch_is_kept_per_dtype():
    r = np.random.default_rng(1)
    ids = np.where(r.random(4000) < 0.5, 3, r.integers(0, 50, 4000))
    p = build_plan(ids, np.ones(4000, bool), piece_rows=8)
    a, b = p.scratch_rows(9), p.scratch_rows(9, torch.float64)
    assert p.n_scratch > 0 and a.dtype == torch.float32 and b.dtype == torch.float64
    assert p.scratch_rows(9) is a and p.scratch_rows(9, torch.float64) is b


# ── the MFU figure's peak, and RuntimeConfig.vocab_axis ──

def test_device_peak_flops_in_float64(monkeypatch):
    """SMs × 64 FP64 lanes × 2 × the max SM clock for a float64 state (an
    H100 SXM's 132 SMs at 1980 MHz: 33.5 TFLOP/s), half the float32 peak;
    an api model on a float64 state takes it."""
    props = types.SimpleNamespace(multi_processor_count=132, uuid="abc")
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda i: props)
    monkeypatch.setattr(engine, "_max_sm_clock_hz", lambda i: 1.98e9)
    engine._cuda_peak_flops.cache_clear()
    try:
        cuda = torch.device("cuda", 0)
        assert engine.device_peak_flops(cuda, torch.float64) == 132 * 64 * 2 * 1.98e9
        assert engine.device_peak_flops(cuda, "float64") == 132 * 64 * 2 * 1.98e9
        assert engine.device_peak_flops(cuda) == 132 * 128 * 2 * 1.98e9
        assert engine.device_peak_flops("cpu", torch.float64) == 0.0
        with pytest.raises(ValueError, match="float16"):
            engine.device_peak_flops(cuda, torch.float16)
    finally:
        engine._cuda_peak_flops.cache_clear()


def test_runtime_vocab_axis_round_trips(tmp_path):
    """The field loads from a checkpoint of either package (it was
    skipped before), and a port checkpoint keeps it."""
    corp_j = tm.synth_corpus(M=30, V=20, K=3, seed=5, mean_tokens=15, mean_terms=8)
    corp_t = tt.synth_corpus(M=30, V=20, K=3, seed=5, mean_tokens=15, mean_terms=8)
    jm = tm.LDA(corp_j, 3, runtime=JaxRuntimeConfig(chunk_docs=16, dtype="float64",
                                                     vocab_axis="model"),
                mesh=make_mesh(n_devices=1), seed=3)
    path = str(tmp_path / "jax.npz")
    tm.save_checkpoint(path, jm)
    pm = tt.load_checkpoint(path, corp_t, device="cpu")
    assert pm.runtime.vocab_axis == "model"
    assert tt.RuntimeConfig().vocab_axis == "vocab"
    own = tt.LDA(corp_t, 3, tt.RuntimeConfig(chunk_docs=16, dtype="float64", vocab_axis="tp"),
                 device="cpu")
    path = str(tmp_path / "port.npz")
    tt.save_checkpoint(path, own)
    assert tt.load_checkpoint(path, corp_t, device="cpu").runtime.vocab_axis == "tp"
    back = tm.load_checkpoint(path, corp_j)
    assert back.runtime.vocab_axis == "tp"
