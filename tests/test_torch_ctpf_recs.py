"""CTPF's ``scores``, ``urecs`` and ``drecs`` setters on the port, held
against the JAX package on CPU.

Assigned scores define the ranking when any of them is non-zero (all
zeros give the unranked complements), an assigned ``drecs``/``urecs`` is
kept as it was given and shown by ``showdrecs``/``showurecs``, and
training drops an assigned ranking for the trained one.  Each case runs
the same numpy inputs through both packages, the port on the CPU in
float64 from the JAX init, and asks for equal lists and equal printed
text.
"""

import numpy as np
import pytest

import topicmodelsvb_jl_tpu as tm
from topicmodelsvb_jl_tpu.parallel.mesh import make_mesh
from topicmodelsvb_jl_tpu.utils.config import RuntimeConfig as JaxRuntimeConfig
import topicmodelsvb_jl_torch as tt
from topicmodelsvb_jl_torch import convert

CORPUS = dict(M=40, V=30, K=3, U=12, seed=9, mean_tokens=20, mean_terms=10, mean_readers=3)
K, CHUNK = 3, 16


def _corpus(pkg):
    c = pkg.synth_corpus(**CORPUS)
    for d, doc in enumerate(c.docs, start=1):
        if d % 4 == 0:
            doc.title = f"paper {d}"
    return c


@pytest.fixture()
def models():
    jm = tm.CTPF(_corpus(tm), K, runtime=JaxRuntimeConfig(chunk_docs=CHUNK, dtype="float64"),
                 mesh=make_mesh(n_devices=1), seed=4)
    pm = tt.CTPF(_corpus(tt), K, tt.RuntimeConfig(chunk_docs=CHUNK, dtype="float64"),
                 device="cpu", seed=4)
    pm.state = convert.state_for(pm, {k: np.asarray(v) for k, v in jm.state._asdict().items()})
    return jm, pm


def _scores(M, U, seed=0):
    """Scores with ties (one decimal), so the stable order matters."""
    return np.round(np.random.default_rng(seed).random((M, U)), 1)


def _shown(model, capsys):
    model.showdrecs(U=4)
    model.showurecs(M=4)
    return capsys.readouterr().out


def _complement(model, kind):
    """The unranked rows: every user (document) not in the row's own
    readers (library), in index order, 1-based."""
    if kind == "d":
        return [[u for u in range(1, model.U + 1) if u not in set(d.readers)]
                for d in model.corp.docs]
    return [[d for d in range(1, model.M + 1) if d not in set(lib)] for lib in model.libs]


def test_assigned_scores_rank_as_in_jax(models, capsys):
    jm, pm = models
    assert pm.drecs[:] == jm.drecs[:] == _complement(pm, "d")   # untrained: unranked
    s = _scores(pm.M, pm.U)
    jm.scores = s
    pm.scores = s
    np.testing.assert_array_equal(pm.scores, s)
    assert pm.drecs[:] == jm.drecs[:] and pm.urecs[:] == jm.urecs[:]
    assert pm.drecs[:] != _complement(pm, "d")
    want = _shown(jm, capsys)
    assert "1. " in want and _shown(pm, capsys) == want


def test_zero_scores_give_the_complements(models, capsys):
    jm, pm = models
    jm.scores = _scores(jm.M, jm.U)   # ranked first, then zeroed
    pm.scores = _scores(pm.M, pm.U)
    z = np.zeros((pm.M, pm.U))
    jm.scores = z
    pm.scores = z
    assert pm.drecs[:] == jm.drecs[:] == _complement(pm, "d")
    assert pm.urecs[:] == jm.urecs[:] == _complement(pm, "u")
    assert _shown(pm, capsys) == _shown(jm, capsys)


def test_assigned_recs_are_kept_and_shown(models, capsys):
    jm, pm = models
    drecs = [[(d + u) % pm.U + 1 for u in range(3)] for d in range(pm.M)]
    urecs = [[(u * 7 + d) % pm.M + 1 for d in range(5)] for u in range(pm.U)]
    for m in (jm, pm):
        m.drecs = drecs
        m.urecs = urecs
    assert pm.drecs is drecs and pm.urecs is urecs
    want = _shown(jm, capsys)
    assert _shown(pm, capsys) == want
    pm.showdrecs(docs=2, U=2)
    names = [pm.corp.users[u] for u in drecs[1][:2]]
    assert capsys.readouterr().out.splitlines()[-2:] == [f"1. {names[0]}", f"2. {names[1]}"]


def test_training_drops_assigned_ranking(models, capsys):
    jm, pm = models
    s = _scores(pm.M, pm.U, seed=1)
    jm.scores = s
    pm.scores = s
    before = pm.drecs[:]
    jm.train(iter=2, checkelbo=1, printelbo=False)
    pm.train(iter=2, checkelbo=1, printelbo=False)
    np.testing.assert_allclose([r.elbo for r in pm.trainer.trace],
                               [r.elbo for r in jm.trainer.trace], rtol=1e-8)
    np.testing.assert_allclose(pm.scores, jm.scores, rtol=1e-8)
    assert pm.drecs[:] == jm.drecs[:] and pm.urecs[:] == jm.urecs[:]
    assert pm.drecs[:] != before
    assert _shown(pm, capsys) == _shown(jm, capsys)
