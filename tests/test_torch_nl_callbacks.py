"""The port's dense ``.nl`` compiler (madnlp_tpu_torch/models/nl.py,
``read_nl``) and the COPS instances (models/instances/cops.py) against the
JAX package's, at the callback level: the JAX callbacks of a model are
``jax.jit``-ed together, once per model, and evaluated at the same seeded
points as the port's ``torch.func`` callbacks (no solve).

* The ``.nl`` fixtures of tests/test_nl.py (hs15, the LP, the defined
  variable) and ``TIES_NL`` (every opcode; tests/test_torch_nl_parse.py):
  ``obj``, ``grad``, ``cons``, ``jac`` and the Lagrangian Hessian at
  seeded points and, for ``TIES_NL``, at points on the ties of ``max`` /
  ``min`` / ``less``, the kink of ``abs`` and the steps of ``floor`` /
  ``ceil``, where both packages split or zero the derivative alike.
* ``minsurf_nl(8)`` through the dense compiler: tests/test_torch_nl_sparse.py
  (against the JAX package's template compiler densified, the same
  function; the JAX dense compile of 128 unrolled terms takes minutes).
* ``cops.elec(15)``, ``cops.chain(50)``, ``cops.torsion(16)`` and
  ``cops.minsurf(16)`` (the sizes of tests/test_cops.py): the same x0 and
  bounds, and the same five callbacks at x0 and seeded points.

Values within rtol 1e-13 (atol 1e-14), derivatives within rtol 1e-12
(atol 1e-13), as in tests/test_nl_sparse.py: the packages sum in other
orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madnlp_tpu.models import nl as jnl
from madnlp_tpu.models.instances import cops as jcops
from madnlp_tpu_torch.models import nl as tnl
from madnlp_tpu_torch.models.instances import cops as tcops
from tests.test_nl import DEFVAR_NL, HS15_NL, LP_NL
from tests.test_torch_nl_parse import TIES_NL

torch.set_num_threads(1)

VALUE = dict(rtol=1e-13, atol=1e-14)
DERIV = dict(rtol=1e-12, atol=1e-13)

# (x0, x1, x2) on ties and kinks: the three-way max tie and the min, less
# and `if` ties at x0 == x1, abs at x2 = 0, floor/ceil at integers, rem
# at a multiple of its divisor, and one point off every tie
TIE_POINTS = [[0.5, 0.5, 0.0], [1.0, 1.0, 0.0], [0.7, 0.7, 0.0],
              [-1.0, -1.0, 0.0], [0.3, -0.4, 0.0]]


def _jitted(model):
    """A model's five dense callbacks as one ``jax.jit``-ed function of
    (x, y), compiled once."""
    jac = model.jac if model.is_dense else model.jac_dense
    hess = model.lag_hess if model.is_dense else model.lag_hess_dense
    return model.m, jax.jit(lambda x, y: (
        model.obj(x), model.grad(x), model.cons(x), jac(x), hess(x, y, 0.7)))


def _check_callbacks(jm, tm, points, seed=0):
    """The port model ``tm``'s dense callbacks against the JAX model's
    jitted ones ``jm = _jitted(model)`` at ``points``."""
    m, jf = jm
    rng = np.random.default_rng(seed)
    for pt in points:
        x = np.asarray(pt, dtype=np.float64)
        y = rng.standard_normal(m)
        tx = torch.as_tensor(x)
        obj, grad, cons, jac, hess = jf(jnp.asarray(x), jnp.asarray(y))
        np.testing.assert_allclose(tm.obj(tx).numpy(), obj, **VALUE)
        np.testing.assert_allclose(tm.grad(tx).numpy(), grad, **DERIV)
        if m:
            np.testing.assert_allclose(tm.cons(tx).numpy(), cons, **VALUE)
            np.testing.assert_allclose(tm.jac(tx).numpy(), jac, **DERIV)
        np.testing.assert_allclose(
            tm.lag_hess(tx, torch.as_tensor(y), 0.7).numpy(), hess, **DERIV)


def _points(n, seed, k=3, lo=-1.5, hi=1.5):
    rng = np.random.default_rng(seed)
    return [rng.uniform(lo, hi, n) for _ in range(k)]


NL = {"hs15": HS15_NL, "lp": LP_NL, "defvar": DEFVAR_NL, "ties": TIES_NL}


@pytest.fixture
def nl_file(tmp_path):
    def write(text, name="model.nl"):
        p = tmp_path / name
        p.write_text(text)
        return str(p)

    return write


@pytest.mark.parametrize("name", sorted(NL))
def test_dense_compiler_matches_jax(nl_file, name):
    path = nl_file(NL[name])
    jm, tm = jnl.read_nl(path), tnl.read_nl(path)
    assert (tm.n, tm.m, tm.minimize) == (jm.n, jm.m, jm.minimize)
    for f in ("x0", "y0", "lvar", "uvar", "lcon", "ucon"):
        np.testing.assert_array_equal(getattr(tm, f), getattr(jm, f))
    points = _points(tm.n, seed=len(name))
    if name == "ties":
        points += TIE_POINTS
    _check_callbacks(_jitted(jm), tm, points)


COPS = {
    "elec": dict(np_=15, seed=0),
    "chain": dict(nh=50),
    "torsion": dict(nx=16),
    "minsurf": dict(nx=16),
}


@pytest.mark.parametrize("name", sorted(COPS))
def test_cops_instance_matches_jax(name):
    jm = getattr(jcops, name)(**COPS[name])
    tm = getattr(tcops, name)(**COPS[name])
    assert (tm.n, tm.m, tm.name) == (jm.n, jm.m, jm.name)
    for f in ("x0", "lvar", "uvar", "lcon", "ucon"):
        np.testing.assert_array_equal(getattr(tm, f), np.asarray(getattr(jm, f)))
    x0 = np.asarray(jm.x0)
    rng = np.random.default_rng(len(name))
    points = [x0] + [x0 + 0.1 * rng.standard_normal(tm.n) for _ in range(2)]
    _check_callbacks(_jitted(jm), tm, points)
