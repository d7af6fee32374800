"""The port's front ends (madnlp_tpu_torch/models/frontends.py) against the
JAX package's, on the CPU, with the models of tests/test_frontends.py.

* ``from_scipy``: HS15 in scipy vocabulary (``Bounds`` and a
  ``NonlinearConstraint``), solved by both packages: status, iterations,
  ``factorization_cnt`` and ``backsolve_cnt`` exactly, the objective
  within 1e-8 relative.  The dict and ``LinearConstraint`` forms: the
  port's constraint callbacks equal the JAX package's (``jax.jit``-ed,
  at seeded points) and its solve meets scipy's SLSQP.
* ``host_model`` without ``lag_hess`` under compact L-BFGS, solved by both
  packages and held the same way; its placeholder Hessian raises.  With
  ``lag_hess``: the analytic optimum, the callbacks run on numpy arrays
  (opaque code), and the host round trips per iteration are counted.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import Bounds, LinearConstraint, NonlinearConstraint

import madnlp_tpu as J
import madnlp_tpu_torch as T

torch.set_num_threads(1)

OBJ_RTOL = 1e-8


def _counts(s):
    return (s.status.name, s.iter, s.counters["factorization_cnt"],
            s.counters["backsolve_cnt"])


def _held(port, ref):
    assert _counts(port) == _counts(ref)
    assert abs(port.objective - ref.objective) <= OBJ_RTOL * abs(ref.objective)


def _hs15(frontend, stack):
    return frontend(
        fun=lambda x: 100.0 * (x[1] - x[0] ** 2) ** 2 + (1.0 - x[0]) ** 2,
        x0=np.zeros(2),
        bounds=Bounds(lb=[-np.inf, -np.inf], ub=[0.5, np.inf]),
        constraints=[NonlinearConstraint(
            lambda x: stack([x[0] * x[1], x[0] + x[1] ** 2]),
            lb=[1.0, 0.0], ub=[np.inf, np.inf])],
    )


def test_from_scipy_nonlinear_constraint_matches_jax():
    ref = J.madnlp(_hs15(J.from_scipy, jnp.stack), print_level="ERROR")
    port = T.madnlp(_hs15(T.from_scipy, torch.stack), device="cpu",
                    print_level="ERROR")
    _held(port, ref)
    assert port.status == T.Status.SOLVE_SUCCEEDED
    np.testing.assert_allclose(port.objective, 360.379767, rtol=1e-6)


def _dict_and_linear(frontend):
    return frontend(
        fun=lambda x: ((x - 1.0) ** 2).sum(),
        x0=np.zeros(3),
        constraints=[
            {"type": "eq", "fun": lambda x: x[0] + x[1] + x[2] - 1.0},
            LinearConstraint(np.array([[1.0, -1.0, 0.0]]), lb=-1.0,
                             ub=np.inf),
            {"type": "ineq", "fun": lambda x: 2.0 - x[2] * x[2]},
        ],
    )


def test_from_scipy_dict_and_linear():
    jm, tm = _dict_and_linear(J.from_scipy), _dict_and_linear(T.from_scipy)
    assert (tm.n, tm.m) == (jm.n, jm.m) == (3, 3)
    np.testing.assert_array_equal(tm.lcon, jm.lcon)
    np.testing.assert_array_equal(tm.ucon, jm.ucon)
    jf = jax.jit(lambda x: (jm.cons(x), jm.jac(x)))
    rng = np.random.default_rng(0)
    for x in rng.standard_normal((3, 3)):
        tx = torch.as_tensor(x)
        cons, jac = jf(jnp.asarray(x))
        np.testing.assert_allclose(tm.cons(tx).numpy(), cons,
                                   rtol=1e-13, atol=1e-14)
        np.testing.assert_allclose(tm.jac(tx).numpy(), jac,
                                   rtol=1e-12, atol=1e-13)
    st = T.madnlp(tm, device="cpu", print_level="ERROR")
    assert st.status == T.Status.SOLVE_SUCCEEDED
    np.testing.assert_allclose(np.sum(st.solution), 1.0, atol=1e-8)
    from scipy.optimize import minimize

    ref = minimize(
        lambda x: np.sum((x - 1.0) ** 2), np.zeros(3), method="SLSQP",
        constraints=[
            {"type": "eq", "fun": lambda x: x[0] + x[1] + x[2] - 1.0},
            {"type": "ineq", "fun": lambda x: x[0] - x[1] + 1.0},
            {"type": "ineq", "fun": lambda x: 2.0 - x[2] * x[2]},
        ],
    )
    np.testing.assert_allclose(st.solution, ref.x, atol=1e-6)


def _lbfgs_model(frontend):
    def obj(x):
        x = np.asarray(x)
        return float(np.sum((x - 2.0) ** 2))

    def grad(x):
        return 2.0 * (np.asarray(x) - 2.0)

    return frontend(obj, np.zeros(4), grad, uvar=np.full(4, 1.5))


def test_host_model_lbfgs_matches_jax():
    ref = J.madnlp(_lbfgs_model(J.host_model), print_level="ERROR",
                   hessian_approximation=J.HessianApproximation.COMPACT_LBFGS)
    model = _lbfgs_model(T.host_model)
    port = T.madnlp(model, device="cpu", print_level="ERROR",
                    hessian_approximation=T.HessianApproximation.COMPACT_LBFGS)
    _held(port, ref)
    np.testing.assert_allclose(port.solution, np.full(4, 1.5), atol=1e-7)
    x = torch.zeros(4, dtype=torch.float64)
    with pytest.raises(NotImplementedError, match="COMPACT_LBFGS"):
        model.lag_hess(x, x[:0], 1.0)


def test_host_model_opaque_numpy():
    """Opaque NumPy callbacks: they see numpy arrays, never tensors, and
    each call is one host round trip."""
    P = np.diag([1.0, 2.0, 3.0])
    calls = {}

    def counted(name, fn):
        def f(*args):
            assert all(isinstance(a, np.ndarray) for a in args), name
            calls[name] = calls.get(name, 0) + 1
            return fn(*args)
        return f

    model = T.host_model(
        counted("obj", lambda x: 0.5 * x @ P @ x - np.sum(x)), np.zeros(3),
        counted("grad", lambda x: P @ x - 1.0), m=1,
        cons=counted("cons", lambda x: np.array([np.sum(x)])),
        jac=counted("jac", lambda x: np.ones((1, 3))),
        lag_hess=counted("lag_hess", lambda x, y, ow: ow * P),
        lcon=[1.0], ucon=[1.0],
    )
    st = T.madnlp(model, device="cpu", print_level="ERROR")
    assert st.status == T.Status.SOLVE_SUCCEEDED
    # analytic: minimize 1/2 x'Px - 1'x s.t. 1'x = 1
    pinv1 = np.linalg.solve(P, np.ones(3))
    lam = (1.0 - np.sum(pinv1)) / np.sum(pinv1)
    np.testing.assert_allclose(st.solution, np.linalg.solve(
        P, 1.0 + lam * np.ones(3)), atol=1e-7)
    assert calls["lag_hess"] == st.counters["hess_cnt"]
    assert calls["obj"] >= st.counters["obj_cnt"]


def test_host_model_with_constraints_needs_their_callbacks():
    with pytest.raises(ValueError, match="requires cons and jac"):
        T.host_model(lambda x: 0.0, np.zeros(2), lambda x: np.zeros(2), m=1)
