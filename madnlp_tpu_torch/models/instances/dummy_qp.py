"""Random dense QP — port of ``madnlp_tpu/models/instances/dummy_qp.py``
(``build``, the same data for the same seed), the reference's
``DenseDummyQP`` (lib/MadNLPTests/src/Instances/dummy_qp.jl):

    min ½ xᵀPx + qᵀx   s.t.  0 <= A x <= 1,  0 <= x <= 1

with P SPD, A banded (+1/-1 diagonals), optional fixed variables and
equality rows.
"""

from __future__ import annotations

import numpy as np

from ..model import DenseNLPModel, DeviceConstants


def build(n=100, m=10, fixed_variables=(), equality_cons=(),
          seed=1) -> DenseNLPModel:
    if not m < n:
        raise ValueError(f"dummy_qp needs m < n (got m={m}, n={n})")
    rng = np.random.default_rng(seed)
    q = rng.standard_normal(n)
    P = rng.standard_normal((n, n))
    P = P @ P.T + 100.0 * np.eye(n)

    xl = np.zeros(n)
    xu = np.ones(n)
    gl = np.zeros(m)
    gu = np.ones(m)
    gu[list(equality_cons)] = 0.0
    xl[list(fixed_variables)] = xu[list(fixed_variables)]

    A = np.zeros((m, n))
    for i in range(m):
        A[i, i] = 1.0
        A[i, i + 1] = -1.0
    K = DeviceConstants(P=P, q=q, A=A)

    def obj(x):
        k = K.on(x.device)
        return 0.5 * x @ (k.P @ x) + k.q @ x

    def cons(x):
        return K.on(x.device).A @ x

    def grad(x):
        k = K.on(x.device)
        return k.P @ x + k.q

    def jac(x):
        return K.on(x.device).A.clone()

    def lag_hess(x, y, obj_weight):
        return obj_weight * K.on(x.device).P

    return DenseNLPModel(
        n=n,
        m=m,
        obj=obj,
        cons=cons,
        grad=grad,
        jac=jac,
        lag_hess=lag_hess,
        x0=np.zeros(n),
        lvar=xl,
        uvar=xu,
        lcon=gl,
        ucon=gu,
        name="dense_dummy_qp",
    )
