"""Model-state invariant validation (reference ``check_model``).

The reference validates every variational parameter at the top of each
``train!`` (modelutils.jl:39-360).  Here each predicate is a reduction on
the state's device; the flags are stacked into one bool tensor and read
back once.
"""

from __future__ import annotations

import torch


def _finite(x):
    return torch.all(torch.isfinite(x))


def _positive(x):
    return torch.all(x > 0) & _finite(x)


def _stochastic(x, dim, atol=1e-3):
    """Rows/cols sum to 1 (reference isstochastic, utils.jl:144-154)."""
    return torch.all(torch.abs(torch.sum(x, dim=dim) - 1.0) <= atol) & torch.all(x >= 0)


def state_violations(model) -> list:
    """Names of violated invariants for a model's current state."""
    from .api import LDA

    if not isinstance(model, LDA):
        raise TypeError(type(model))
    s = model.state
    checks = {                                  # modelutils.jl:39-67
        "alpha must be positive": _positive(s.alpha),
        "beta must be a stochastic matrix": _stochastic(s.beta, dim=1),
        "gamma must be positive": _positive(s.gamma),
        "Elogtheta must be finite": _finite(s.Elogtheta),
    }
    flags = torch.stack(list(checks.values())).cpu().tolist()
    return [name for name, ok in zip(checks, flags) if not ok]


def check_model(model) -> None:
    """Raise TopicModelError on any violated state invariant
    (reference check_model, modelutils.jl:39-360)."""
    from .api import TopicModelError

    bad = state_violations(model)
    if bad:
        raise TopicModelError("; ".join(bad) + ".")
