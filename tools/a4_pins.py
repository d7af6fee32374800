#!/usr/bin/env python3
"""The JAX package's numbers that ``chip_smoke.py``'s A4 phases are held
to, one JSON line per run: (status, iterations, factorization_cnt,
backsolve_cnt, objective), and HYKKT's CG iterations where the run has a
CG.

* ``unreduced`` — ``opf.build_sparse(nb=NB, seed=0)`` under
  ``kkt_system=SPARSE_UNREDUCED, linear_solver=BANDED``;
* ``condensed`` — the same model under ``SPARSE_CONDENSED`` + ``BANDED``
  at ``tol=1e-6`` (the tolerance of the JAX package's own tests of this
  system);
* ``range_space`` — the dense ``opf.build(nb=NB, seed=0)`` under
  ``kkt_system=DENSE`` with ``linear_solver=HYKKT,
  hykkt_backend="ldl"`` (K_γ by the blocked LDLᵀ, the algorithm of the
  port's K7); and, in float64, the one-variable infeasible model of ``tests/test_config_matrix.py`` under ``DENSE`` + HYKKT, which
  ends INFEASIBLE_PROBLEM_DETECTED through HYKKT's ``rr`` mode (under the
  default condensed system HYKKT would become Cholesky: the model has no
  equality row);
* ``block_cholesky`` — the dense model under ``DENSE`` +
  ``BLOCK_CHOLESKY`` (``--max-iter`` bounds a run that does not converge:
  of nb = 80, 90, 95-118, 150, 200, 250, 300 and 450 it reaches a
  solution in 400 iterations at 90, 95, 102 and 107 only, and at 600 none
  in 100).

``--dtype float64`` (default) runs the default band backend (the XLA band
loop on the CPU); ``float32`` runs the banded systems through the Pallas
kernels in interpret mode (the TPU kernel's order, which the port's K1/K2
follow).  Run on the CPU from the repository root:

    JAX_PLATFORMS=cpu PYTHONPATH=. python tools/a4_pins.py CASE \\
        [--nb 600] [--dtype float64|float32]
"""

import argparse
import json
import time

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402

import madnlp_tpu as J  # noqa: E402
from madnlp_tpu.models.instances import opf  # noqa: E402


def _line(name, s, wall, **extra):
    print(json.dumps({"run": name, "pin": [
        s.status.name, s.iter, s.counters["factorization_cnt"],
        s.counters["backsolve_cnt"], s.objective], "seconds": wall,
        **extra}), flush=True)


def _solve(name, model, **opts):
    t = time.time()
    s = J.madnlp(model, print_level="ERROR", **opts)
    _line(name, s, time.time() - t,
          options={k: str(v) for k, v in opts.items()})


def infeasible_model():
    """The one-variable infeasible model of
    ``tests/test_config_matrix.py:test_hykkt_restoration_path``."""
    return J.create_model(
        obj=lambda x: x[0], cons=lambda x: jnp.array([x[0]]),
        n=1, m=1, x0=[0.0], lvar=[1.0], lcon=[0.0], ucon=[0.5])


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("case", choices=("unreduced", "condensed",
                                     "range_space", "block_cholesky"))
    ap.add_argument("--nb", type=int, default=600)
    ap.add_argument("--max-iter", type=int, default=3000)
    ap.add_argument("--dtype", default="float64")
    a = ap.parse_args()
    LS, KS = J.LinearSolver, J.KKTSystem
    banded = {"linear_solver": LS.BANDED, "dtype": a.dtype}
    if a.dtype == "float32":
        banded["banded_backend"] = "pallas_interpret"
    if a.case == "unreduced":
        _solve(f"unreduced nb{a.nb} {a.dtype}",
               opf.build_sparse(nb=a.nb, seed=0),
               kkt_system=KS.SPARSE_UNREDUCED, **banded)
    elif a.case == "condensed":
        _solve(f"condensed nb{a.nb} {a.dtype}",
               opf.build_sparse(nb=a.nb, seed=0),
               kkt_system=KS.SPARSE_CONDENSED, tol=1e-6, **banded)
    elif a.case == "block_cholesky":
        _solve(f"block_cholesky nb{a.nb} {a.dtype}",
               opf.build(nb=a.nb, seed=0), kkt_system=KS.DENSE,
               linear_solver=LS.BLOCK_CHOLESKY, dtype=a.dtype,
               max_iter=a.max_iter)
    else:
        _solve(f"hykkt nb{a.nb} {a.dtype}", opf.build(nb=a.nb, seed=0),
               kkt_system=KS.DENSE, linear_solver=LS.HYKKT,
               hykkt_backend="ldl", dtype=a.dtype)
        if a.dtype == "float64":
            _solve("hykkt infeasible", infeasible_model(),
                   kkt_system=KS.DENSE, linear_solver=LS.HYKKT,
                   hykkt_backend="ldl")


if __name__ == "__main__":
    main()
