"""Whole solves of slice A4 against the JAX package on the CPU: four JAX
solves, each once per module.  The dense HYKKT solve is ``slow``: with it
the slice's new files took 91.7 and 96.4 worker-seconds in tier-1 against
their budget of 90 (ROADMAP §C, T1); HYKKT on that model's KKT system
stays held to the JAX package in tier-1 by tests/test_torch_a4_kkt.py.

* ``opf.build_sparse(nb=14, seed=0)`` under ``SPARSE_UNREDUCED`` +
  ``BANDED`` (K1/K2's plain versions on the 3·nw + m band): status,
  iterations, factorizations and backsolves exactly the JAX package's, the
  objective within 1e-8 relative.
* The same model under ``SPARSE_CONDENSED`` + ``BANDED`` at ``tol=1e-6``:
  status exactly, the objective within 1e-8 relative; the counts inside the
  JAX package's own one-ulp spread.  The condensed matrix holds JᵀDJ with
  D ~ 1/ε² over the relaxed equality rows, so the reduced Hessian on
  null(J) sits at float64 rounding of it: moving x0 by at most one ulp
  moves the JAX package to 11-12 iterations, 11-18 factorizations and
  23-68 backsolves at nb=14 (``JAX_PACKAGE_SPREAD``:
  ``JAX_PLATFORMS=cpu PYTHONPATH=. python tools/spread.py condensed --pkg
  jax --seeds 6``; ROADMAP §C, R3).
* The dense ``opf.build(nb=14, seed=0)`` under ``DENSE`` + HYKKT with
  ``hykkt_backend="ldl"``: status, iterations, factorizations and
  backsolves exactly the JAX package's, the objective within 1e-8
  relative; every step runs the CG on K_γ, factored by K7's plain version
  once per factorization (and once for the least-squares start), never by
  a Cholesky.
* The one-variable infeasible model (tests/test_config_matrix.py) under
  ``DENSE`` + HYKKT with ``hykkt_backend="ldl"``: INFEASIBLE_PROBLEM_DETECTED
  exactly as the JAX package; its regular steps run the CG, its robust
  steps factor in HYKKT's ``rr`` mode (K_c, no CG); K_γ factored by K7's
  plain version once per factorization (and once for the least-squares
  start), never by a Cholesky.

The port-only contracts of the slice are in tests/test_torch_a4_port.py.
"""

import numpy as np
import pytest
import torch

import madnlp_tpu_torch as T
from madnlp_tpu_torch.models.instances import opf as topf
from madnlp_tpu_torch.ops import dense_kernels as dk
from madnlp_tpu_torch.ops import dense_solvers as ds

torch.set_num_threads(1)

OBJ_RTOL = 1e-8
# tools/spread.py condensed --pkg jax --seeds 6 (seeds 0-6, x0 moved by at
# most one ulp): the ranges of (iter, factorization_cnt, backsolve_cnt)
JAX_PACKAGE_SPREAD = {"iter": (11, 12), "factorization_cnt": (11, 18),
                      "backsolve_cnt": (23, 68)}

CONFIGS = {
    "unreduced": ("sparse", dict(kkt_system="sparse_unreduced",
                                 linear_solver="banded")),
    "condensed": ("sparse", dict(kkt_system="sparse_condensed",
                                 linear_solver="banded", tol=1e-6)),
    "dense_hykkt": ("dense", dict(kkt_system="dense", linear_solver="hykkt",
                                  hykkt_backend="ldl")),
    "infeasible": ("infeasible", dict(kkt_system="dense",
                                      linear_solver="hykkt",
                                      hykkt_backend="ldl")),
}
_JAX = {}


def _model(pkg, kind):
    if kind == "infeasible":
        if pkg == "jax":
            import jax.numpy as jnp
            import madnlp_tpu as J
            return J.create_model(
                obj=lambda x: x[0], cons=lambda x: jnp.array([x[0]]),
                n=1, m=1, x0=[0.0], lvar=[1.0], lcon=[0.0], ucon=[0.5])
        return T.create_model(
            obj=lambda x: x[0], cons=lambda x: torch.stack([x[0]]),
            n=1, m=1, x0=[0.0], lvar=[1.0], lcon=[0.0], ucon=[0.5])
    if pkg == "jax":
        from madnlp_tpu.models.instances import opf
    else:
        opf = topf
    return getattr(opf, "build_sparse" if kind == "sparse" else "build")(
        nb=14, seed=0)


def _jax(name):
    """The JAX package's solve of ``CONFIGS[name]``, once per module."""
    if name not in _JAX:
        import madnlp_tpu as J
        kind, opts = CONFIGS[name]
        _JAX[name] = J.madnlp(_model("jax", kind), print_level="error",
                              **opts)
    return _JAX[name]


def _port(name, **extra):
    kind, opts = CONFIGS[name]
    return T.madnlp(_model("port", kind), device="cpu", print_level="error",
                    **opts, **extra)


def _counts(s):
    return (s.status.name, s.iter, s.counters["factorization_cnt"],
            s.counters["backsolve_cnt"])


def _objective_close(a, b):
    assert abs(a.objective - b.objective) <= OBJ_RTOL * abs(b.objective), (
        a.objective, b.objective)


@pytest.mark.parametrize("name", [
    "unreduced", pytest.param("dense_hykkt", marks=pytest.mark.slow),
    "infeasible"])
def test_a4_solve_matches_jax(name, monkeypatch):
    ref = _jax(name)
    launches, rr = [], []
    dense_ldlt, factorize = dk.dense_ldlt, ds.factorize

    def counted(A, block=128):
        launches.append(A.shape[0])
        return dense_ldlt(A, block)

    def seen(K, solver, *args, **kwargs):
        rr.append(kwargs.get("rr", False))
        return factorize(K, solver, *args, **kwargs)
    monkeypatch.setattr(dk, "dense_ldlt", counted)
    monkeypatch.setattr(ds, "factorize", seen)
    monkeypatch.setattr(torch.linalg, "cholesky_ex", _no_cholesky)
    ds.reset_cg_stats()
    s = _port(name)
    assert _counts(s) == _counts(ref)
    _objective_close(s, ref)
    assert np.isfinite(s.solution).all()
    if name == "unreduced":
        return
    # K_γ through K7's plain version: one LDLᵀ per factorization, and one
    # for the least-squares start (uncounted, as in the JAX package)
    assert len(launches) == len(rr) == s.counters["factorization_cnt"] + 1
    # the regular steps run the CG, one host read per iteration and one
    # per solve; the robust steps factor K_c (rr: no γ, no CG)
    cg = ds.CG_STATS
    assert cg["solves"] > 0
    assert cg["host_reads"] == cg["iterations"] + cg["solves"]
    if name == "infeasible":
        assert cg["solves"] < s.counters["backsolve_cnt"] and any(rr)
    else:
        assert not any(rr)


def _no_cholesky(*args, **kwargs):
    raise AssertionError("HYKKT under hykkt_backend='ldl' ran a Cholesky")


def test_sparse_condensed_matches_jax():
    ref = _jax("condensed")
    s = _port("condensed")
    assert s.status == ref.status == T.Status.SOLVE_SUCCEEDED
    _objective_close(s, ref)
    got = {"iter": s.iter, **{k: s.counters[k] for k in
                               ("factorization_cnt", "backsolve_cnt")}}
    jax_got = {"iter": ref.iter, **{k: ref.counters[k] for k in
                                     ("factorization_cnt", "backsolve_cnt")}}
    for k, (lo, hi) in JAX_PACKAGE_SPREAD.items():
        assert lo <= jax_got[k] <= hi and lo <= got[k] <= hi, (k, got, jax_got)
