"""``examples/walkthrough_torch.py``, the port's end-to-end story.

The slow test runs all ten sections in a subprocess on the CPU
(``WALKTHROUGH_DEVICE=cpu``) with every size shrunk by the knobs of the
JAX walkthrough's test, and asserts it completes without loading JAX.
The fast ones check that the file imports neither JAX nor the JAX
package, and that without the knob it needs the card: its first model's
constructor raises where no CUDA device is.
"""

import ast
import os
import runpy
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "examples", "walkthrough_torch.py")
SMALL = dict(WALKTHROUGH_DOCS="200", WALKTHROUGH_CITEU_DOCS="200", WALKTHROUGH_GEN_DOCS="120",
             WALKTHROUGH_STREAM_DOCS="512", WALKTHROUGH_HMTM_DOCS="60", WALKTHROUGH_CTPF_K="8")


def test_walkthrough_imports_no_jax():
    with open(SCRIPT) as f:
        tree = ast.parse(f.read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
    assert "topicmodelsvb_jl_torch" in names
    assert not [n for n in names if n.split(".")[0] in ("jax", "jaxlib", "topicmodelsvb_jl_tpu")]


def test_walkthrough_needs_the_card_by_default(monkeypatch, capsys):
    for k, v in SMALL.items():
        monkeypatch.setenv(k, v)
    monkeypatch.delenv("WALKTHROUGH_DEVICE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        runpy.run_path(SCRIPT, run_name="__main__")
    out = capsys.readouterr().out
    assert "[section 1]" in out and "[section 2]" not in out


@pytest.mark.slow
def test_walkthrough_completes():
    env = dict(os.environ, WALKTHROUGH_DEVICE="cpu", **SMALL)
    code = ("import runpy, sys; "
            f"ns = runpy.run_path({SCRIPT!r}, run_name='__main__'); "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib', "
            "'topicmodelsvb_jl_tpu'))]; "
            "assert not bad, bad; assert sorted(ns['SECTION_TIMES']) == list(range(1, 11))")
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, f"walkthrough failed:\n{r.stderr[-4000:]}"
    assert "walkthrough complete." in r.stdout, r.stdout[-2000:]
