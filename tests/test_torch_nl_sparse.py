"""The port's ``.nl`` template compiler (madnlp_tpu_torch/models/nl_sparse.py,
``read_nl(..., sparse=True)``) against the JAX package's, at the callback
level: the JAX callbacks of a model ``jax.jit``-ed together, once per
model, evaluated at the same seeded points as the port's (no solve).

* The fixtures of tests/test_nl.py, ``TIES_NL`` (every opcode, also at
  its ties and kinks), ``chain_nl(40)`` (tests/test_nl_sparse.py: one
  template for all constraints, one for all objective terms) and
  ``minsurf_nl(8)`` (one template for all 128 cell terms, two of whose
  four slots are one variable: the ×2 weight of a mirrored diagonal; its
  dense compile too, against the JAX template compiler densified).
* The sparsity patterns exactly: ``nnzj``, ``nnzh`` and the COO rows and
  columns in the JAX package's order.
* ``obj``, ``grad``, ``cons``, ``jac_coords`` and ``hess_coords`` within
  rtol 1e-13 (values) and 1e-12 (derivatives), as in
  tests/test_nl_sparse.py: the port sums a constraint row's and a
  gradient entry's terms through host-built segment maps where the JAX
  package scatter-adds, so the packages sum in other orders.
* ``minsurf_nl(8)``'s objective equals the JAX package's
  ``cops.minsurf(8)`` at the same points (rtol 1e-13): the generator
  writes the COPS model.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madnlp_tpu.models import nl as jnl
from madnlp_tpu.models.instances import cops as jcops
from madnlp_tpu_torch.models import nl as tnl
from madnlp_tpu_torch.testing import minsurf_nl
from tests.test_nl import DEFVAR_NL, HS15_NL, LP_NL
from tests.test_nl_sparse import chain_nl
from tests.test_torch_nl_callbacks import TIE_POINTS
from tests.test_torch_nl_parse import TIES_NL

torch.set_num_threads(1)

VALUE = dict(rtol=1e-13, atol=1e-14)
DERIV = dict(rtol=1e-12, atol=1e-13)

MODELS = {"hs15": HS15_NL, "lp": LP_NL, "defvar": DEFVAR_NL,
          "ties": TIES_NL, "chain40": chain_nl(40), "minsurf8": minsurf_nl(8)}


@pytest.fixture
def nl_file(tmp_path):
    def write(text, name="model.nl"):
        p = tmp_path / name
        p.write_text(text)
        return str(p)

    return write


def _points(name, n):
    rng = np.random.default_rng(n)
    if name == "chain40":
        return [rng.uniform(0.5, 2.0, n) for _ in range(3)]
    pts = [rng.uniform(-1.5, 1.5, n) for _ in range(3)]
    if name == "ties":
        pts += [np.asarray(p) for p in TIE_POINTS]
    if name == "minsurf8":
        pts = [rng.uniform(0.0, 1.0, n) for _ in range(3)]
    return pts


@pytest.mark.parametrize("name", sorted(MODELS))
def test_template_compiler_matches_jax(nl_file, name):
    path = nl_file(MODELS[name])
    jm = jnl.read_nl(path, sparse=True)
    tm = tnl.read_nl(path, sparse=True)
    assert not tm.is_dense
    assert (tm.n, tm.m, tm.nnzj, tm.nnzh, tm.minimize) == \
        (jm.n, jm.m, jm.nnzj, jm.nnzh, jm.minimize)
    for f in ("jac_rows", "jac_cols", "hess_rows", "hess_cols"):
        np.testing.assert_array_equal(getattr(tm, f), getattr(jm, f))
    for f in ("x0", "y0", "lvar", "uvar", "lcon", "ucon"):
        np.testing.assert_array_equal(getattr(tm, f), getattr(jm, f))
    # the port's dense compiler of minsurf_nl(8) too, against the JAX
    # package's template compiler densified (the same function)
    dense = tnl.read_nl(path) if name == "minsurf8" else None
    jf = jax.jit(lambda x, y: (
        jm.obj(x), jm.grad(x), jm.cons(x), jm.jac_coords(x),
        jm.hess_coords(x, y, 0.7))
        + ((jm.lag_hess_dense(x, y, 0.7),) if dense else ()))
    rng = np.random.default_rng(1)
    for x in _points(name, tm.n):
        y = rng.standard_normal(tm.m)
        tx, ty = torch.as_tensor(x), torch.as_tensor(y)
        obj, grad, cons, jac, hess, *full = jf(jnp.asarray(x), jnp.asarray(y))
        np.testing.assert_allclose(tm.obj(tx).numpy(), obj, **VALUE)
        np.testing.assert_allclose(tm.grad(tx).numpy(), grad, **DERIV)
        np.testing.assert_allclose(tm.cons(tx).numpy(), cons, **VALUE)
        np.testing.assert_allclose(tm.jac_coords(tx).numpy(), jac, **DERIV)
        np.testing.assert_allclose(tm.hess_coords(tx, ty, 0.7).numpy(),
                                   hess, **DERIV)
        if dense is not None:
            np.testing.assert_allclose(dense.obj(tx).numpy(), obj, **VALUE)
            np.testing.assert_allclose(dense.grad(tx).numpy(), grad, **DERIV)
            np.testing.assert_allclose(dense.lag_hess(tx, ty, 0.7).numpy(),
                                       full[0], **DERIV)


def test_chain_grouping_and_sparsity(nl_file):
    n = 40
    tm = tnl.read_nl(nl_file(chain_nl(n)), sparse=True)
    assert tm.nnzj == 2 * (n - 1)
    assert tm.nnzh == n + (n - 1)
    pat = set(zip(tm.hess_rows.tolist(), tm.hess_cols.tolist()))
    assert all(r == c or r == c + 1 for r, c in pat)


def test_minsurf_nl_is_the_cops_model(nl_file):
    nx = 8
    tm = tnl.read_nl(nl_file(minsurf_nl(nx)), sparse=True)
    ref = jcops.minsurf(nx)
    np.testing.assert_array_equal(tm.x0, ref.x0)
    np.testing.assert_array_equal(tm.lvar, ref.lvar)
    np.testing.assert_array_equal(tm.uvar, ref.uvar)
    # 2·nx² cell terms of one template, 10 slot pairs each
    assert tm.nnzh == 2 * nx * nx * 10
    obj = jax.jit(ref.obj)
    rng = np.random.default_rng(0)
    for x in [ref.x0] + [rng.uniform(0.0, 2.0, tm.n) for _ in range(3)]:
        np.testing.assert_allclose(
            tm.obj(torch.as_tensor(x)).numpy(), obj(jnp.asarray(x)), **VALUE)


def test_segment_map_of_no_segments():
    """A model without constraints sums its rows through a map of no
    segments (the defined-variable fixture, m = 0); ``segment_map`` built
    its slot starts with a concatenation that failed there."""
    from madnlp_tpu_torch.ops.segment import segment_map, segment_sum

    table = segment_map(np.zeros(0, dtype=np.int64), 0)
    assert table.shape == (0, 1)
    out = segment_sum(torch.zeros(0, dtype=torch.float64),
                      torch.as_tensor(table))
    assert out.shape == (0,)
    # and the order within a segment is the input order, as before
    np.testing.assert_array_equal(segment_map(np.array([1, 0, 1]), 3),
                                  [[1, 3], [0, 2], [3, 3]])
