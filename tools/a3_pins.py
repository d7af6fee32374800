#!/usr/bin/env python3
"""The JAX package's numbers that ``chip_smoke.py``'s front-end phases are
held to, one JSON line per run: (status, iterations, factorization_cnt,
backsolve_cnt, objective).

* ``nl`` — ``minsurf_nl(100)`` (``madnlp_tpu_torch/testing.py``, a
  10,201-variable COPS minimal surface) through the JAX package's
  ``solve_nl`` with ``sparse="auto"`` (the template compiler, n ≥ 256),
  float64 with the default band backend and float32 through the Pallas
  kernels in interpret mode (the TPU kernel's order, which the port
  follows), and float32 with the default backend (the XLA band loop,
  reported beside); also the JAX package's band geometry;
* ``frontends`` — the models of ``tests/test_frontends.py``: HS15 through
  ``from_scipy`` (a ``NonlinearConstraint``), the dict and
  ``LinearConstraint`` model, ``host_model`` with ``lag_hess`` and
  ``host_model`` without it under compact L-BFGS.

Run on the CPU from the repository root:

    JAX_PLATFORMS=cpu PYTHONPATH=. python tools/a3_pins.py nl|frontends

(``nl`` takes about 5 min, ``frontends`` about 1 min on one core.)
"""

import json
import os
import sys
import tempfile

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from scipy.optimize import (  # noqa: E402
    Bounds,
    LinearConstraint,
    NonlinearConstraint,
)

import madnlp_tpu as J  # noqa: E402
from madnlp_tpu.models import nl as jnl  # noqa: E402


def _line(name, s, **extra):
    print(json.dumps({"run": name, "pin": [
        s.status.name, s.iter, s.counters["factorization_cnt"],
        s.counters["backsolve_cnt"], s.objective], **extra}), flush=True)


def nl():
    from madnlp_tpu_torch.testing import minsurf_nl

    d = tempfile.mkdtemp()
    path = os.path.join(d, "minsurf.nl")
    with open(path, "w") as f:
        f.write(minsurf_nl(100))
    solver = J.MadNLPSolver(jnl.read_nl(path, sparse=True),
                            print_level="ERROR")
    st = solver.kernel.kkt.bstruct if hasattr(solver.kernel.kkt, "bstruct") \
        else None
    geometry = ({k: int(getattr(st, k)) for k in ("N", "b", "bw", "nb")}
                if st is not None else None)
    for dtype, backend in (("float64", "auto"),
                           ("float32", "pallas_interpret"),
                           ("float32", "auto")):
        s = jnl.solve_nl(path, dtype=dtype, banded_backend=backend,
                         print_level="ERROR")
        _line(f"minsurf_nl(100) {dtype} {backend}", s,
              linear_solver=str(solver.opts.linear_solver),
              geometry=geometry)


def frontends():
    P = np.diag([1.0, 2.0, 3.0])
    runs = {
        "scipy_hs15": (J.from_scipy(
            fun=lambda x: 100.0 * (x[1] - x[0] ** 2) ** 2 + (1.0 - x[0]) ** 2,
            x0=np.zeros(2),
            bounds=Bounds(lb=[-np.inf, -np.inf], ub=[0.5, np.inf]),
            constraints=[NonlinearConstraint(
                lambda x: jnp.stack([x[0] * x[1], x[0] + x[1] ** 2]),
                lb=[1.0, 0.0], ub=[np.inf, np.inf])]), {}),
        "scipy_dict_linear": (J.from_scipy(
            fun=lambda x: ((x - 1.0) ** 2).sum(),
            x0=np.zeros(3),
            constraints=[
                {"type": "eq", "fun": lambda x: x[0] + x[1] + x[2] - 1.0},
                LinearConstraint(np.array([[1.0, -1.0, 0.0]]), lb=-1.0,
                                 ub=np.inf)]), {}),
        "host_qp": (J.host_model(
            lambda x: 0.5 * x @ P @ x - np.sum(x), np.zeros(3),
            lambda x: P @ x - 1.0, m=1,
            cons=lambda x: np.array([np.sum(x)]),
            jac=lambda x: np.ones((1, 3)),
            lag_hess=lambda x, y, ow: ow * P,
            lcon=[1.0], ucon=[1.0]), {}),
        "host_lbfgs": (J.host_model(
            lambda x: float(np.sum((x - 2.0) ** 2)), np.zeros(4),
            lambda x: 2.0 * (x - 2.0), uvar=np.full(4, 1.5)),
            {"hessian_approximation":
             J.HessianApproximation.COMPACT_LBFGS}),
    }
    for name, (model, opts) in runs.items():
        _line(name, J.madnlp(model, print_level="ERROR", **opts))


if __name__ == "__main__":
    {"nl": nl, "frontends": frontends}[sys.argv[1]]()
