"""Model-state invariant validation (reference ``check_model``).

The reference validates every variational parameter at the top of each
``train!`` (modelutils.jl:39-360).  Here each predicate is a reduction on
the state's device; the flags are stacked into one bool tensor (combined
over the processes of a sharded model) and read back once.  CTM and fCTM add a Cholesky test of sigma on the host in f64
([K, K] is small).
"""

from __future__ import annotations

import numpy as np
import torch


def _finite(x):
    return torch.all(torch.isfinite(x))


def _positive(x):
    return torch.all(x > 0) & _finite(x)


def _stochastic(x, dim, atol=1e-3):
    """Rows/cols sum to 1 (reference isstochastic, utils.jl:144-154)."""
    return torch.all(torch.abs(torch.sum(x, dim=dim) - 1.0) <= atol) & torch.all(x >= 0)


def _unit_interval(x):
    return torch.all((x >= 0) & (x <= 1)) & _finite(x)


def state_violations(model) -> list:
    """Names of violated invariants for a model's current state."""
    from .api import CTM, CTPF, DTM, HMTM, LDA, fCTM, fLDA

    s = model.state
    if isinstance(model, (LDA, fLDA)):          # modelutils.jl:39-67, 69-106
        checks = {
            "alpha must be positive": _positive(s.alpha),
            "beta must be a stochastic matrix": _stochastic(s.beta, dim=1),
            "gamma must be positive": _positive(s.gamma),
            "Elogtheta must be finite": _finite(s.Elogtheta),
        }
        if isinstance(model, fLDA):
            checks.update({
                "eta must be in [0, 1]": _unit_interval(s.eta),
                "kappa must be a stochastic matrix": _stochastic(s.kappa, dim=0),
                "tau must be in [0, 1]": _unit_interval(s.tau),
            })
    elif isinstance(model, CTM):                # modelutils.jl:108-178, fCTM included
        checks = {
            "mu must be finite": _finite(s.mu),
            "sigma must be finite": _finite(s.sigma),
            # the reference never requires invsigma finite (its todo.txt:7)
            "invsigma must be finite": _finite(s.invsigma),
            "beta must be a stochastic matrix": _stochastic(s.beta, dim=1),
            "lambda must be finite": _finite(s.lam),
            "vsq must be positive": _positive(s.vsq),
            "logzeta must be finite": _finite(s.logzeta),
        }
        if isinstance(model, fCTM):
            checks.update({
                "eta must be in [0, 1]": _unit_interval(s.eta),
                "kappa must be a stochastic matrix": _stochastic(s.kappa, dim=0),
                "tau must be in [0, 1]": _unit_interval(s.tau),
            })
    elif isinstance(model, DTM):                # v0.6 fixmodel! analogue
        checks = {
            "alpha must be positive": _positive(s.alpha),
            "betahat must be finite": _finite(s.betahat),
            "mbeta must be finite": _finite(s.mbeta),
            "vbeta must be positive": _positive(s.vbeta),
            "gamma must be positive": _positive(s.gamma),
            "lzeta must be finite": _finite(s.lzeta),
        }
    elif isinstance(model, HMTM):               # the completed HMTM stub
        checks = {
            "eta must be positive": _positive(s.eta),
            "alpha must be positive": _positive(s.alpha),
            "beta must be a stochastic matrix": _stochastic(s.beta, dim=1),
            "tau must be positive": _positive(s.tau),
            "gamma must be positive": _positive(s.gamma),
        }
    elif isinstance(model, CTPF):               # modelutils.jl:181-253
        checks = {f"{name} must be positive": _positive(getattr(s, name))
                  for name in ("alef", "bet", "gimel", "dalet", "he", "vav",
                               "zayin", "het")}
    else:
        raise TypeError(type(model))
    ok = torch.stack(list(checks.values()))
    mesh = getattr(model, "_red_mesh", None)
    if mesh is not None:
        # the per-document checks see this process's rows: combine them, so
        # every process raises alike and none waits in a later collective
        from .parallel.shard import psum

        ok = psum((~ok).to(torch.int32), mesh, model.runtime.data_axis) == 0
    flags = ok.cpu().tolist()
    bad = [name for name, ok in zip(checks, flags) if not ok]
    if isinstance(model, CTM) and not bad:      # sigma posdef (modelutils.jl:116-118)
        try:
            np.linalg.cholesky(s.sigma.detach().cpu().double().numpy())
        except np.linalg.LinAlgError:
            bad.append("sigma must be positive definite")
    return bad


def check_model(model) -> None:
    """Raise TopicModelError on any violated state invariant
    (reference check_model, modelutils.jl:39-360)."""
    from .api import TopicModelError

    bad = state_violations(model)
    if bad:
        raise TopicModelError("; ".join(bad) + ".")
