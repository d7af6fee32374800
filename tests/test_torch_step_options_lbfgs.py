"""Compact L-BFGS against the JAX package (the cases of
tests/test_quasi_newton.py; helpers in tests/test_torch_step_options.py):
on ``sparse_qp.build(n=60, m=15)`` densified on the DENSE system (the
formed operator), on the SPARSE system with dense storage and on the
banded path (the low-rank form: the σ-diagonal assembled, the rest by
Sherman–Morrison–Woodbury at every solve), held as every whole solve of
the slice; and on the 10-variable Rosenbrock function, unconstrained.

Rosenbrock's 120-odd iterations amplify the last bits of the gradients:
the two packages' printed iterates part at iteration 45, and their counts
lie in the one-ulp spread of both (``tools/step_options_spread.py
rosenbrock``: x0 as it is and moved by at most one ulp, six seeds:
123-138 iterations in the JAX package, 119-145 in the port, each ending
SOLVE_SUCCEEDED or SOLVED_TO_ACCEPTABLE_LEVEL). That case is held to the
spread and to the reference test's solution, all ones within 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import madnlp_tpu as J
from madnlp_tpu.models.instances import sparse_qp as jsqp

import madnlp_tpu_torch as T
from madnlp_tpu_torch.models.instances import sparse_qp as tsqp

from test_torch_step_options import assert_same, solve_both

LBFGS = {"hessian_approximation": "HessianApproximation.COMPACT_LBFGS"}
ROSENBROCK_ITERATIONS = (119, 145)


def _rosenbrock(pkg, xp):
    return pkg.create_model(
        obj=lambda x: xp.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2
                             + (1 - x[:-1]) ** 2),
        n=10, x0=np.full(10, -1.2))


CASES = {
    "sparse_qp_dense": (lambda: jsqp.build(n=60, m=15).to_dense(),
                        lambda: tsqp.build(n=60, m=15).to_dense(),
                        {**LBFGS, "kkt_system": "dense"}),
    "sparse_qp_sparse": (lambda: jsqp.build(n=60, m=15),
                         lambda: tsqp.build(n=60, m=15),
                         {**LBFGS, "kkt_system": "sparse"}),
    "sparse_qp_banded": (lambda: jsqp.build(n=60, m=15),
                         lambda: tsqp.build(n=60, m=15),
                         {**LBFGS, "kkt_system": "sparse",
                          "linear_solver": "banded"}),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_compact_lbfgs_solve_matches_jax(name):
    j, t = solve_both(*CASES[name])
    assert t.status == T.Status.SOLVE_SUCCEEDED
    assert t.counters["hess_cnt"] == j.counters["hess_cnt"] == 0
    assert_same(t, j)


def test_compact_lbfgs_rosenbrock_within_the_one_ulp_spread():
    j, t = solve_both(lambda: _rosenbrock(J, jnp),
                      lambda: _rosenbrock(T, torch),
                      {**LBFGS, "max_iter": 1000})
    lo, hi = ROSENBROCK_ITERATIONS
    for s in (j, t):
        assert s.status.name in ("SOLVE_SUCCEEDED",
                                 "SOLVED_TO_ACCEPTABLE_LEVEL")
        assert lo <= s.iter <= hi and s.counters["hess_cnt"] == 0
    assert t.counters["factorization_cnt"] == t.iter
    np.testing.assert_allclose(t.solution, np.ones(10), atol=1e-5)
