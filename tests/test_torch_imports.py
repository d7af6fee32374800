"""The PyTorch port imports nothing of JAX or of the JAX package.

Every ``.py`` file under ``madnlp_tpu_torch/`` and ``chip_smoke.py`` is
parsed with ``ast``; an ``import jax…``, ``from jax…``, ``import
madnlp_tpu…`` or ``from madnlp_tpu…`` (``madnlp_tpu_torch`` itself is
fine) anywhere in a file, at any depth, fails.  A check of ``sys.modules``
in a subprocess cannot show this here: the interpreter imports jax at
start-up in this environment.
"""

import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "madnlp_tpu")


def _sources():
    pkg = os.path.join(ROOT, "madnlp_tpu_torch")
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, files in os.walk(pkg):
        out += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


def _bad_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom):
            # relative imports (level > 0) stay inside the port
            if node.level == 0 and node.module and _forbidden(node.module):
                bad.append(node.module)
    return bad


def test_the_port_has_sources():
    files = [os.path.relpath(p, ROOT) for p in _sources()]
    assert "chip_smoke.py" in files
    assert os.path.join("madnlp_tpu_torch", "models", "matpower.py") in files
    assert len(files) > 20


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_imports(path):
    assert _bad_imports(path) == []


def test_the_check_sees_forbidden_imports(tmp_path):
    src = tmp_path / "probe.py"
    src.write_text("import os\nimport jax.numpy as jnp\n"
                   "def f():\n    from madnlp_tpu.ops import banded\n"
                   "    import madnlp_tpu_torch\n"
                   "    from . import sibling\n")
    assert _bad_imports(str(src)) == ["jax.numpy", "madnlp_tpu.ops"]


A3_MODULES = ("models/nl.py", "models/nl_sparse.py", "models/frontends.py",
              "models/instances/cops.py", "testing.py")


@pytest.mark.parametrize("module", A3_MODULES)
def test_the_front_ends_and_the_harness_are_ported(module):
    path = os.path.join(ROOT, "madnlp_tpu_torch", *module.split("/"))
    assert path in _sources()
    assert _bad_imports(path) == []


def test_the_root_exports_the_front_ends():
    import madnlp_tpu_torch as T
    import madnlp_tpu_torch.testing as mt

    for name in ("from_scipy", "host_model", "read_nl", "solve_nl",
                 "write_sol"):
        assert name in T.__all__ and callable(getattr(T, name))
    for name in ("test_linear_solver", "test_kkt_system",
                 "run_behavior_suite"):
        assert name in mt.__all__ and callable(getattr(mt, name))
    assert callable(T.MadNLPSolver.solve_jitted)
