"""The port's quasi-Newton Hessians (``ipm/quasi_newton.py``) against the
JAX package on the dense path (the cases of tests/test_quasi_newton.py;
helpers in tests/test_torch_step_options.py): BFGS, damped BFGS and
compact L-BFGS on ``hs15.build(x0=(1, 1))``, BFGS and compact L-BFGS on
``dummy_qp.build(20, 5)``. Held as every whole solve of the slice, and
``hess_cnt`` 0 in both packages: the Lagrangian Hessian is never
evaluated."""

import pytest

from madnlp_tpu.models.instances import dummy_qp as jdqp
from madnlp_tpu.models.instances import hs15 as jhs15

import madnlp_tpu_torch as T
from madnlp_tpu_torch.models.instances import dummy_qp as tdqp
from madnlp_tpu_torch.models.instances import hs15 as ths15

from test_torch_step_options import assert_same, solve_both

H = "hessian_approximation"
CASES = {
    "hs15_bfgs": (lambda: jhs15.build(x0=(1.0, 1.0)),
                  lambda: ths15.build(x0=(1.0, 1.0)),
                  {H: "HessianApproximation.BFGS", "max_iter": 300}),
    "hs15_damped_bfgs": (lambda: jhs15.build(x0=(1.0, 1.0)),
                         lambda: ths15.build(x0=(1.0, 1.0)),
                         {H: "HessianApproximation.DAMPED_BFGS",
                          "max_iter": 300}),
    "hs15_compact_lbfgs": (lambda: jhs15.build(x0=(1.0, 1.0)),
                           lambda: ths15.build(x0=(1.0, 1.0)),
                           {H: "HessianApproximation.COMPACT_LBFGS",
                            "max_iter": 300}),
    "dummy_qp_bfgs": (lambda: jdqp.build(20, 5), lambda: tdqp.build(20, 5),
                      {H: "HessianApproximation.BFGS", "max_iter": 500}),
    "dummy_qp_compact_lbfgs": (lambda: jdqp.build(20, 5),
                               lambda: tdqp.build(20, 5),
                               {H: "HessianApproximation.COMPACT_LBFGS",
                                "max_iter": 500}),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_quasi_newton_solve_matches_jax(name):
    j, t = solve_both(*CASES[name])
    assert t.status == T.Status.SOLVE_SUCCEEDED
    assert t.counters["hess_cnt"] == j.counters["hess_cnt"] == 0
    assert_same(t, j)
