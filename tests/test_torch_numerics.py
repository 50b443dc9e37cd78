"""Numerics of the PyTorch port against the JAX package, in f64 on CPU.

Inputs are drawn with numpy and fed to both packages; tolerances are the
f64 ones the JAX package holds its own oracle tests to.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from topicmodelsvb_jl_tpu.kernels.lda_estep import digamma_series as jax_digamma_series
from topicmodelsvb_jl_tpu.ops.newton import dirichlet_newton as jax_newton
from topicmodelsvb_jl_tpu.utils import numerics as jnum
from topicmodelsvb_jl_torch.kernels.lda_estep import digamma_series
from topicmodelsvb_jl_torch.ops.newton import dirichlet_newton
from topicmodelsvb_jl_torch.ops.segment import count_scatter_into
from topicmodelsvb_jl_torch.utils import numerics as tnum


def _t(a):
    return torch.tensor(np.asarray(a))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_digamma_series_matches_jax(dtype):
    x = np.concatenate([np.linspace(1e-3, 0.9, 50), np.linspace(1.0, 50.0, 50),
                        np.linspace(100.0, 5e4, 20)]).astype(dtype)
    got = digamma_series(_t(x)).numpy()
    want = np.asarray(jax_digamma_series(jnp.asarray(x)))
    rtol = 1e-14 if dtype == np.float64 else 2e-6
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol)


def test_digamma_series_matches_special():
    """The series' truncation error is below f32 resolution."""
    x = np.linspace(1e-3, 200.0, 400)
    got = digamma_series(_t(x))
    np.testing.assert_allclose(got.numpy(), torch.special.digamma(_t(x)).numpy(),
                               rtol=0, atol=5e-10)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kbn_matches_jax(seed):
    """Compensated accumulation is the same arithmetic: equal bit for bit."""
    r = np.random.default_rng(seed)
    xs = r.normal(0, 1e6, size=(40, 5)) * r.uniform(1e-8, 1, size=(40, 5))
    tacc, jacc = tnum.kbn_zeros((5,), torch.float64), jnum.kbn_zeros((5,), jnp.float64)
    for x in xs:
        tacc = tnum.kbn_add(tacc, _t(x))
        jacc = jnum.kbn_add(jacc, jnp.asarray(x))
    other = (_t(xs[0]), _t(xs[1] * 1e-9))
    tm = tnum.kbn_pack(tnum.kbn_merge(tacc, other))
    jm = jnum.kbn_pack(jnum.kbn_merge(jacc, (jnp.asarray(xs[0]), jnp.asarray(xs[1] * 1e-9))))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert tnum.elbo_value(tm[:, 0]) == jnum.elbo_value(np.asarray(jm)[:, 0])


def test_kbn_recovers_lost_digits():
    acc = tnum.kbn_zero(torch.float32)
    for x in [1e8, 1.0, -1e8, 1.0]:
        acc = tnum.kbn_add(acc, torch.tensor(x, dtype=torch.float32))
    assert tnum.elbo_value(tnum.kbn_pack(acc)) == 2.0


@pytest.mark.parametrize("K,seed", [(4, 0), (7, 1), (16, 2)])
def test_dirichlet_newton_matches_jax(K, seed):
    r = np.random.default_rng(seed)
    M = 500.0
    alpha0 = r.uniform(0.3, 3.0, K)
    El_sum = M * (r.uniform(-4.0, -1.0, K))
    lo = r.normal(0, 1e-9, K)
    got = dirichlet_newton(_t(alpha0), _t(El_sum), M, 1000, 1.0 / K**2,
                           Elogtheta_sum_lo=_t(lo)).numpy()
    want = np.asarray(jax_newton(jnp.asarray(alpha0), jnp.asarray(El_sum), M,
                                 1000, 1.0 / K**2,
                                 Elogtheta_sum_lo=jnp.asarray(lo)))
    np.testing.assert_allclose(got, want, rtol=1e-10)


def test_dirichlet_newton_f32_close_to_f64():
    r = np.random.default_rng(5)
    K, M = 10, 2000.0
    alpha0 = r.uniform(0.5, 2.0, K)
    El_sum = M * r.uniform(-4.0, -1.5, K)
    a64 = dirichlet_newton(_t(alpha0), _t(El_sum), M, 1000, 1e-2).numpy()
    a32 = dirichlet_newton(_t(alpha0).float(), _t(El_sum).float(), M, 1000,
                           1e-2).numpy()
    assert a32.dtype == np.float32
    np.testing.assert_allclose(a32, a64, rtol=1e-3)


def test_dirichlet_entropy_and_finite_match_jax():
    r = np.random.default_rng(3)
    g = r.uniform(0.05, 30.0, size=(6, 9))
    np.testing.assert_allclose(tnum.dirichlet_entropy(_t(g)).numpy(),
                               np.asarray(jnum.dirichlet_entropy(jnp.asarray(g))),
                               rtol=1e-12)
    x = np.array([np.inf, -np.inf, 1.5, -2.0])
    np.testing.assert_array_equal(tnum.finite(_t(x)).numpy(),
                                  np.asarray(jnum.finite(jnp.asarray(x))))


def test_dirichlet_ones_rows_are_stochastic_and_seeded():
    g1 = torch.Generator().manual_seed(4)
    g2 = torch.Generator().manual_seed(4)
    a = tnum.dirichlet_ones(g1, 50, (3,), torch.float64)
    b = tnum.dirichlet_ones(g2, 50, (3,), torch.float64)
    assert a.shape == (3, 50) and torch.all(a > 0)
    np.testing.assert_allclose(a.sum(-1).numpy(), 1.0, rtol=1e-12)
    assert torch.equal(a, b)


def test_masked_fixpoint_stops_when_all_lanes_stop():
    calls = []

    def body(i, carry):
        x, active = carry
        calls.append(i)
        x = x + active.to(x.dtype)
        return x, active & (x < torch.tensor([2.0, 3.0]))

    x, active = tnum.masked_fixpoint(
        body, (torch.zeros(2), torch.tensor([True, True])), viter=10)
    assert x.tolist() == [2.0, 3.0] and not active.any()
    assert calls == [0, 1, 2]


def test_count_scatter_into_sums_duplicates():
    acc = torch.zeros(4, 2, dtype=torch.float64)
    ids = torch.tensor([0, 3, 3, 1, 3], dtype=torch.int32)
    w = torch.arange(10, dtype=torch.float64).reshape(5, 2)
    out = count_scatter_into(acc, w, ids)
    assert out is acc
    np.testing.assert_array_equal(
        acc.numpy(), [[0, 1], [6, 7], [0, 0], [2 + 4 + 8, 3 + 5 + 9]])


def test_count_scatter_into_is_bitwise_repeatable_in_f32():
    """Large enough that a multi-threaded atomic scatter would reorder."""
    g = torch.Generator().manual_seed(0)
    ids = (torch.rand(200_000, generator=g) ** 3 * 1000).to(torch.int32)
    w = torch.rand(200_000, 64, generator=g)
    a, b = (count_scatter_into(torch.zeros(1000, 64), w, ids) for _ in range(2))
    assert torch.equal(a, b)
