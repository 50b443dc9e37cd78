"""The port's float32 HMTM bound at K = 300 against the JAX package's, on CPU.

Run as a script (``JAX_PLATFORMS=cpu python tests/test_torch_hmtm_f32.py``)
it prints the four traces and their steps.

At K = 300 the bound of a document sums terms of ~1e5 (the Dirichlet
normalisers over K x K) down to ~-1e2, so a float32 reading rounds by more
than the later iterations' gain.  Both packages run float32 from the JAX
init (carried over by ``convert.py``) with their own jitted or plain step
and bound; each state is also read by the port's float64 bound (the
state cast to float64), which rises every iteration as CAVI does.  The
port's float32 states follow JAX's; its float32 bound stays within its
rounding of that float64 reading, and so does JAX's within its own (a
wider one: its float32 bound reads losses where the float64 reading of
its own states rises).  Where the gain exceeds both roundings (the first
iteration) both float32 readings see it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import topicmodelsvb_jl_tpu as tm
from topicmodelsvb_jl_tpu.models import hmtm as jax_hmtm
from topicmodelsvb_jl_tpu.parallel.mesh import make_mesh
from topicmodelsvb_jl_tpu.utils.config import RuntimeConfig as JaxRuntimeConfig
import topicmodelsvb_jl_torch as tt
from topicmodelsvb_jl_torch import convert
from topicmodelsvb_jl_torch.models import hmtm as torch_hmtm
from topicmodelsvb_jl_torch.utils.numerics import elbo_value
from test_torch_hmtm import _inputs

K, CHUNK, ITERS = 300, 8, 3
FIELDS = ("eta", "alpha", "beta", "tau", "gamma")
STATE_RTOL = 1e-4    # the float32 states' distance per iteration (measured ~4e-6)
PORT_RTOL = 1e-3     # the port's float32 bound against the float64 reading (~4e-4)
JAX_RTOL = 3e-3      # the JAX package's (~1.9e-3)


def _runs(iters=ITERS) -> dict:
    """The two float32 runs from the JAX init, ``iters`` iterations: each
    package's float32 bound (``je``, ``te``: JAX, port) and the float64
    reading of its states (``jr``, ``tr``) at the init and after each
    iteration; the states checked against each other on the way."""
    jin, tin = _inputs("corpus")
    jm = tm.HMTM(jin, K, runtime=JaxRuntimeConfig(chunk_docs=CHUNK, dtype="float32",
                                                  pad_multiple=8),
                 mesh=make_mesh(n_devices=1), seed=3)
    pm = tt.HMTM(tin, K, tt.RuntimeConfig(chunk_docs=CHUNK, dtype="float32", pad_multiple=8),
                 device="cpu", seed=3)
    p = jm.packed
    kw = dict(viter=10, vtol=1.0 / K**2, niter=1000, ntol=1.0 / K**2, chunk_docs=CHUNK)
    jstep = jax.jit(jax_hmtm.make_step(p, K, **kw))
    jelbo = jax.jit(jax_hmtm.make_elbo(p, K, chunk_docs=CHUNK))
    tstep = torch_hmtm.make_step(pm.packed, K, device="cpu", **kw)
    telbo = torch_hmtm.make_elbo(pm.packed, K, chunk_docs=CHUNK)
    jdata = tuple(tuple(jnp.asarray(getattr(s, f)) for s in p.segments)
                  for f in ("terms", "counts", "doc_mask"))
    tdata = pm._data_arrays()
    tdata64 = tuple(tuple(x.double() if x.is_floating_point() else x for x in d)
                    for d in tdata)

    def read64(state_np):
        return elbo_value(telbo(convert.hmtm_state_from_numpy(state_np, "cpu", torch.float64),
                                *tdata64))

    js = jm.state
    init = {f: np.asarray(v) for f, v in js._asdict().items()}
    ts = convert.hmtm_state_from_numpy(init, "cpu", torch.float32)
    assert ts.gamma.dtype == torch.float32 and js.gamma.dtype == jnp.float32
    je, te, jr, tr = [float(jnp.sum(jelbo(js, *jdata)))], [elbo_value(telbo(ts, *tdata))], \
        [read64(init)], [read64(init)]
    for it in range(1, iters + 1):
        js = jstep(js, *jdata, jnp.asarray(float(p.M), jnp.float32))
        ts = tstep(ts, *tdata, float(pm.M))
        jn = {f: np.asarray(v) for f, v in js._asdict().items()}
        tn = convert.hmtm_state_to_numpy(ts)
        for f in FIELDS:
            assert tn[f].dtype == np.float32, f
            np.testing.assert_allclose(tn[f], jn[f], rtol=STATE_RTOL, atol=1e-6,
                                       err_msg=f"{f} at iteration {it}")
        je.append(float(jnp.sum(jelbo(js, *jdata))))
        te.append(elbo_value(telbo(ts, *tdata)))
        jr.append(read64(jn))
        tr.append(read64(tn))
    return {k: np.array(v) for k, v in dict(je=je, te=te, jr=jr, tr=tr).items()}


def test_float32_bound_at_k300_follows_jax_and_the_float64_reading():
    run = _runs()
    je, te, jr, tr = run["je"], run["te"], run["jr"], run["tr"]
    # the float64 reading of both trajectories: one bound, rising every iteration
    np.testing.assert_allclose(tr, jr, rtol=1e-6)
    assert np.all(np.diff(tr) > 0), np.diff(tr)
    # each float32 bound within its rounding of the float64 reading
    assert np.all(np.abs(te - tr) <= PORT_RTOL * np.abs(tr)), (te, tr)
    assert np.all(np.abs(je - jr) <= JAX_RTOL * np.abs(jr)), (je, jr)
    # where the gain exceeds both roundings, both float32 readings see it
    big = np.diff(tr) > (PORT_RTOL + JAX_RTOL) * np.abs(tr[1:])
    assert big[0]
    assert np.all(np.diff(te)[big] > 0) and np.all(np.diff(je)[big] > 0)


if __name__ == "__main__":
    # the figures behind the test: JAX_PLATFORMS=cpu python tests/test_torch_hmtm_f32.py
    jax.config.update("jax_enable_x64", True)
    for name, v in _runs().items():
        print(name, " ".join(f"{x:.4f}" for x in v), "| deltas",
              " ".join(f"{x:+.4f}" for x in np.diff(v)))
