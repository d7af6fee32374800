"""Whole solves and single iterations of the port (madnlp_tpu_torch) against
the JAX package, on the CPU, with the banded KKT path of the flagship
configuration.

* ``hs15`` and ``sparse_qp``: the same status, iteration count,
  ``factorization_cnt`` and ``backsolve_cnt``, the objective within 1e-8
  relative, and the iteration log and EXIT line byte for byte (timings
  aside).
* ``opf.build_sparse(nb=40, seed=2)`` in float64 with μ-scaled
  refinement: the same status and counters, the objective within 1e-8.
* one ``regular_step`` of each package from the same JAX state, carried
  across with ``state_from_arrays``: the new iterate within 1e-9 relative
  (float64; the two factorizations differ in summation order) and the same
  counters, step and status.
* the entry points run on the card unless told otherwise.
"""

import re

import numpy as np
import pytest
import torch

import jax

import madnlp_tpu as J
from madnlp_tpu.models.instances import hs15 as jhs15
from madnlp_tpu.models.instances import opf as jopf
from madnlp_tpu.models.instances import sparse_qp as jqp
from madnlp_tpu.utils.options import RichardsonOptions as JRichardson

import madnlp_tpu_torch as T
from madnlp_tpu_torch.ipm.state import state_from_arrays
from madnlp_tpu_torch.models.instances import hs15 as ths15
from madnlp_tpu_torch.models.instances import opf as topf
from madnlp_tpu_torch.models.instances import sparse_qp as tqp
from madnlp_tpu_torch.utils.options import (
    BarrierUpdate,
    HessianApproximation,
    RichardsonOptions as TRichardson,
)

torch.set_num_threads(1)

OBJ_RTOL = 1e-8
COUNTERS = ("factorization_cnt", "backsolve_cnt")
# lines of the log that carry wall-clock times
_TIMED = re.compile(r"seconds|[Tt]ime")

CASES = {
    "hs15": (jhs15.build_sparse, ths15.build_sparse),
    "sparse_qp": (lambda: jqp.build(n=200, m=50),
                  lambda: tqp.build(n=200, m=50)),
}


def _log_lines(text):
    return [ln for ln in text.splitlines() if ln and not _TIMED.search(ln)]


@pytest.fixture(scope="module")
def jax_solves():
    """The JAX package's solve of each case, with its printed log (each
    compiled once for the module)."""
    return {}


def _jax_solve(cache, capsys, name):
    if name not in cache:
        capsys.readouterr()
        stats = J.madnlp(CASES[name][0](), linear_solver=J.LinearSolver.BANDED)
        cache[name] = (stats, capsys.readouterr().out)
    return cache[name]


@pytest.mark.parametrize("name", sorted(CASES))
def test_solve_and_log_match_jax(name, jax_solves, capsys):
    jstats, jlog = _jax_solve(jax_solves, capsys, name)
    capsys.readouterr()
    tstats = T.madnlp(CASES[name][1](), device="cpu",
                      linear_solver=T.LinearSolver.BANDED)
    tlog = capsys.readouterr().out
    assert tstats.status.name == jstats.status.name == "SOLVE_SUCCEEDED"
    assert tstats.iter == jstats.iter
    for c in COUNTERS:
        assert tstats.counters[c] == jstats.counters[c], c
    assert abs(tstats.objective - jstats.objective) <= OBJ_RTOL * abs(jstats.objective)
    np.testing.assert_allclose(tstats.solution, np.asarray(jstats.solution),
                               rtol=1e-6, atol=1e-8)
    assert _log_lines(tlog) == _log_lines(jlog)


def _jax_state_arrays(st):
    """The leaves of a JAX ``State`` as numpy, under the keys
    ``state_from_arrays`` reads."""
    out = {}
    for name, v in zip(st._fields, st):
        if name in ("d", "p"):
            for part, a in zip(v._fields, v):
                out[f"{name}.{part}"] = np.asarray(a)
        elif name == "filter":
            out["filter.th"], out["filter.ph"], out["filter.count"] = (
                np.asarray(a) for a in v)
        elif name == "scal":
            out["scal.obj_scale"] = np.asarray(v.obj_scale)
            out["scal.con_scale"] = np.asarray(v.con_scale)
        elif isinstance(v, (jax.Array, np.ndarray)):
            out[name] = np.asarray(v)
    return out


def _rel(a, ref):
    """Normwise relative difference; equal entries (infinite bounds
    included) count as zero."""
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    with np.errstate(invalid="ignore"):
        diff = np.where(a == ref, 0.0, np.abs(a - ref))
    scale = np.max(np.abs(ref[np.isfinite(ref)]), initial=0.0)
    return np.max(diff, initial=0.0) / max(scale, 1e-300)


def _opts(pkg, richardson):
    return dict(linear_solver=pkg.LinearSolver.BANDED,
                print_level=pkg.PrintLevel.ERROR,
                richardson=richardson(mu_scaled=True))


@pytest.fixture(scope="module")
def jax_opf40():
    """The JAX package's solver for ``opf.build_sparse(nb=40, seed=2)`` in
    float64 (its initialize and regular step compiled once)."""
    return J.MadNLPSolver(jopf.build_sparse(nb=40, seed=2),
                          **_opts(J, JRichardson))


def _torch_opf40():
    return T.MadNLPSolver(topf.build_sparse(nb=40, seed=2), device="cpu",
                          **_opts(T, TRichardson))


@pytest.mark.parametrize("k", [0, 6])
def test_regular_step_from_a_jax_state(k, jax_opf40):
    st = jax_opf40._init_fn(())
    for _ in range(k):
        st = jax_opf40._regular(st)
    tst = state_from_arrays(_jax_state_arrays(st), "cpu")
    assert tst.k == k
    tst = _torch_opf40().kernel.regular_step(tst)
    st = jax_opf40._regular(st)
    assert tst.status == int(st.status)
    for f in ("k", "factorization_cnt", "backsolve_cnt", "l_cnt", "ftype",
              "obj_cnt", "con_cnt", "grad_cnt", "jac_cnt", "hess_cnt"):
        assert getattr(tst, f) == int(getattr(st, f)), f
    for f in ("x", "y", "zl", "zu", "xl", "xu", "c", "f"):
        assert _rel(getattr(tst, f), getattr(st, f)) < 1e-9, f
    for f in ("mu", "tau", "alpha", "alpha_z", "del_w", "obj_val", "inf_pr",
              "inf_du", "inf_compl"):
        assert _rel(getattr(tst, f), getattr(st, f)) < 1e-9, f


def test_opf_solve_matches_jax_float64(jax_opf40):
    """The float64 flagship configuration at nb=40: counters exact."""
    jstats = jax_opf40.solve()
    tstats = _torch_opf40().solve()
    assert tstats.status.name == jstats.status.name == "SOLVE_SUCCEEDED"
    assert tstats.iter == jstats.iter == 18
    for c in COUNTERS:
        assert tstats.counters[c] == jstats.counters[c], c
    assert abs(tstats.objective - jstats.objective) <= OBJ_RTOL * abs(jstats.objective)


def test_entry_points_need_cuda_unless_told():
    model = ths15.build_sparse()
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA"):
        T.madnlp(model)
    with pytest.raises(RuntimeError, match="CUDA"):
        T.MadNLPSolver(model, device="cuda")


@pytest.mark.parametrize("opts", [
    dict(linear_solver=T.LinearSolver.HYKKT),
    dict(kkt_system=T.KKTSystem.SPARSE_CONDENSED),
    dict(barrier=BarrierUpdate.QUALITY_FUNCTION),
    dict(hessian_approximation=HessianApproximation.COMPACT_LBFGS),
    dict(inertia_correction_method=T.InertiaCorrection.FREE),
])
def test_later_slices_raise(opts):
    """The step options run in the single solve (slice A2) and in
    ``solve_batch`` (slice A2b), where only ``sharding=`` still raises;
    the KKT systems and solvers of slice A4 run in the single solve, and
    ``solve_batch`` on them (slice A4b) raises at its entry."""
    a4 = "linear_solver" in opts or "kkt_system" in opts
    opts = {"linear_solver": T.LinearSolver.BANDED, **opts}
    if a4 and opts.get("kkt_system") == T.KKTSystem.SPARSE_CONDENSED:
        opts["tol"] = 1e-6
    solver = T.MadNLPSolver(ths15.build_sparse(), device="cpu",
                            print_level=T.PrintLevel.ERROR, **opts)
    with pytest.raises(NotImplementedError, match="later slice"):
        if a4:
            solver.solve_batch([1.0, 1.1])
        else:
            solver.solve_batch([1.0, 1.1], sharding=object())
    assert solver.solve().status == T.Status.SOLVE_SUCCEEDED
    with pytest.raises(NotImplementedError, match="later slice"):
        T.MadNLPSolver(ths15.build_sparse(), device="cpu").solve_batch([])


def test_full_memory_bfgs_needs_dense_storage():
    with pytest.raises(NotImplementedError, match="dense Hessian storage"):
        T.MadNLPSolver(tqp.build(n=60, m=15), device="cpu",
                       hessian_approximation=T.HessianApproximation.BFGS)


def test_banded_backend_is_the_device():
    with pytest.raises(ValueError, match="auto"):
        T.MadNLPSolver(ths15.build_sparse(), device="cpu",
                       linear_solver=T.LinearSolver.BANDED,
                       banded_backend="pallas")
