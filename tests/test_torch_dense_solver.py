"""Whole solves of the port's dense path (madnlp_tpu_torch: create_model,
DenseKKT / DenseCondensedKKT, the blocked LDLᵀ) against the JAX package,
on the CPU.

Held to the JAX package: the status, iteration count and
``factorization_cnt`` exactly, the objective within 1e-8 relative, and
``backsolve_cnt`` exactly (float64; the ROADMAP rule), for

* the README's ``create_model`` example written with torch functions, and
  ``hs15.build()`` — with the iteration log and EXIT line byte for byte;
* two Hock–Schittkowski problems, bounds only and an equality: with hs15
  (inequalities) they cover the condensed form without equality rows
  (Cholesky) and with them (LDLᵀ);
* ``opf.build(nb=30, seed=1)`` in float64 and ``seed=2`` in float32
  (``backsolve_cnt`` within 6% there, the ROADMAP's float32 rule);
* one ``slow`` test: ``opf.build(nb=600, seed=0)`` in float32 and float64,
  the configuration ``chip_smoke.py`` runs on the card.

The other problems of tests/test_hs_suite.py and the suite are held to
their published optima, as the JAX package's own tests hold them, and the
two condensations are held to each other: ``DENSE`` and
``DENSE_CONDENSED`` solve the same Newton system, so their iteration
counts are identical (the golden rule, tests/test_condensed.py).
"""

import re

import numpy as np
import pytest
import torch

import madnlp_tpu as J
from madnlp_tpu.models.instances import hs15 as jhs15
from madnlp_tpu.models.instances import opf as jopf

import madnlp_tpu_torch as T
from madnlp_tpu_torch.models.instances import hs15 as ths15
from madnlp_tpu_torch.models.instances import opf as topf
from madnlp_tpu_torch.models.instances import suite as tsuite

torch.set_num_threads(1)

OBJ_RTOL = 1e-8
INF = np.inf
_TIMED = re.compile(r"seconds|[Tt]ime")


def readme_model():
    """The README's first example, with torch functions."""
    return T.create_model(
        obj=lambda x: 100 * (x[1] - x[0] ** 2) ** 2 + (1 - x[0]) ** 2,
        cons=lambda x: torch.stack([x[0] * x[1], x[0] + x[1] ** 2]),
        n=2, m=2, x0=[0.0, 0.0],
        uvar=[0.5, INF], lcon=[1.0, 0.0], ucon=[INF, INF],
    )


# -- Hock–Schittkowski problems (tests/test_hs_suite.py) in torch ------------


def hs01():
    return T.create_model(
        obj=lambda x: 100 * (x[1] - x[0] ** 2) ** 2 + (1 - x[0]) ** 2,
        n=2, x0=[-2.0, 1.0], lvar=[-INF, -1.5]), 0.0


def hs03():
    return T.create_model(
        obj=lambda x: x[1] + 1e-5 * (x[1] - x[0]) ** 2,
        n=2, x0=[10.0, 1.0], lvar=[-INF, 0.0]), 0.0


def hs05():
    return T.create_model(
        obj=lambda x: torch.sin(x[0] + x[1]) + (x[0] - x[1]) ** 2
        - 1.5 * x[0] + 2.5 * x[1] + 1.0,
        n=2, x0=[0.0, 0.0], lvar=[-1.5, -3.0], uvar=[4.0, 3.0],
    ), -1.9132229549810367


def hs06():
    return T.create_model(
        obj=lambda x: (1 - x[0]) ** 2,
        cons=lambda x: 10.0 * (x[1] - x[0] ** 2)[None],
        n=2, m=1, x0=[-1.2, 1.0], lcon=[0.0], ucon=[0.0]), 0.0


def hs07():
    return T.create_model(
        obj=lambda x: torch.log(1 + x[0] ** 2) - x[1],
        cons=lambda x: ((1 + x[0] ** 2) ** 2 + x[1] ** 2 - 4.0)[None],
        n=2, m=1, x0=[2.0, 2.0], lcon=[0.0], ucon=[0.0]), -np.sqrt(3.0)


def hs14():
    return T.create_model(
        obj=lambda x: (x[0] - 2) ** 2 + (x[1] - 1) ** 2,
        cons=lambda x: torch.stack(
            [x[0] - 2 * x[1] + 1, -0.25 * x[0] ** 2 - x[1] ** 2 + 1]),
        n=2, m=2, x0=[2.0, 2.0], lcon=[0.0, 0.0], ucon=[0.0, INF],
    ), 9 - 2.875 * np.sqrt(7)


def hs33():
    return T.create_model(
        obj=lambda x: (x[0] - 1) * (x[0] - 2) * (x[0] - 3) + x[2],
        cons=lambda x: torch.stack(
            [x[2] ** 2 - x[1] ** 2 - x[0] ** 2,
             x[0] ** 2 + x[1] ** 2 + x[2] ** 2 - 4.0]),
        n=3, m=2, x0=[0.0, 0.0, 3.0], lvar=[0.0, 0.0, 0.0],
        uvar=[INF, INF, 5.0], lcon=[0.0, 0.0], ucon=[INF, INF],
    ), np.sqrt(2) - 6


def hs35():
    return T.create_model(
        obj=lambda x: 9 - 8 * x[0] - 6 * x[1] - 4 * x[2]
        + 2 * x[0] ** 2 + 2 * x[1] ** 2 + x[2] ** 2
        + 2 * x[0] * x[1] + 2 * x[0] * x[2],
        cons=lambda x: (3 - x[0] - x[1] - 2 * x[2])[None],
        n=3, m=1, x0=[0.5, 0.5, 0.5], lvar=[0.0] * 3, lcon=[0.0], ucon=[INF],
    ), 1.0 / 9.0


def hs38():
    return T.create_model(
        obj=lambda x: 100 * (x[1] - x[0] ** 2) ** 2 + (1 - x[0]) ** 2
        + 90 * (x[3] - x[2] ** 2) ** 2 + (1 - x[2]) ** 2
        + 10.1 * ((x[1] - 1) ** 2 + (x[3] - 1) ** 2)
        + 19.8 * (x[1] - 1) * (x[3] - 1),
        n=4, x0=[-3.0, -1.0, -3.0, -1.0], lvar=[-10.0] * 4, uvar=[10.0] * 4,
    ), 0.0


def hs52():
    return T.create_model(
        obj=lambda x: (4 * x[0] - x[1]) ** 2 + (x[1] + x[2] - 2) ** 2
        + (x[3] - 1) ** 2 + (x[4] - 1) ** 2,
        cons=lambda x: torch.stack(
            [x[0] + 3 * x[1], x[2] + x[3] - 2 * x[4], x[1] - x[4]]),
        n=5, m=3, x0=[2.0] * 5, lcon=[0.0] * 3, ucon=[0.0] * 3,
    ), 1859.0 / 349.0


def hs71():
    return T.create_model(
        obj=lambda x: x[0] * x[3] * (x[0] + x[1] + x[2]) + x[2],
        cons=lambda x: torch.stack(
            [x[0] * x[1] * x[2] * x[3],
             x[0] ** 2 + x[1] ** 2 + x[2] ** 2 + x[3] ** 2]),
        n=4, m=2, x0=[1.0, 5.0, 5.0, 1.0], lvar=[1.0] * 4, uvar=[5.0] * 4,
        lcon=[25.0, 40.0], ucon=[INF, 40.0],
    ), 17.0140173


def _jax_hs(name):
    """The JAX package's model of tests/test_hs_suite.py (imported lazily:
    that module is a test file of its own)."""
    import importlib
    return getattr(importlib.import_module("test_hs_suite"), name)()[0]


# name -> (JAX model, port model): bounds only (condensed, Cholesky);
# an equality (condensed with an equality row, LDLᵀ).  Inequalities are
# hs15's (condensed without equality rows, Cholesky)
JAX_CASES = {
    "hs05": (lambda: _jax_hs("hs05"), lambda: hs05()[0]),
    "hs06": (lambda: _jax_hs("hs06"), lambda: hs06()[0]),
}
PUBLISHED = [hs01, hs03, hs07, hs14, hs33, hs35, hs38, hs52, hs71]


@pytest.fixture(scope="module")
def jax_solves():
    return {}


def _jax(cache, key, build, capsys=None, **opts):
    if key not in cache:
        if capsys is not None:
            capsys.readouterr()
        stats = J.madnlp(build(), **opts)
        cache[key] = (stats, capsys.readouterr().out if capsys else "")
    return cache[key]


def _same(t, j, backsolves="exact"):
    assert t.status.name == j.status.name
    assert t.iter == j.iter
    assert t.counters["factorization_cnt"] == j.counters["factorization_cnt"]
    tb, jb = t.counters["backsolve_cnt"], j.counters["backsolve_cnt"]
    if backsolves == "exact":
        assert tb == jb
    else:
        assert abs(tb - jb) <= 0.06 * jb
    assert abs(t.objective - j.objective) <= OBJ_RTOL * max(abs(j.objective),
                                                            1e-300)


def _log_lines(text):
    return [ln for ln in text.splitlines() if ln and not _TIMED.search(ln)]


@pytest.mark.parametrize("build", [readme_model, ths15.build],
                         ids=["readme_example", "hs15"])
def test_hs15_and_readme_example_match_jax(build, jax_solves, capsys):
    jstats, jlog = _jax(jax_solves, "hs15", jhs15.build, capsys)
    capsys.readouterr()
    tstats = T.madnlp(build(), device="cpu")
    tlog = capsys.readouterr().out
    assert tstats.status == T.Status.SOLVE_SUCCEEDED
    _same(tstats, jstats)
    np.testing.assert_allclose(tstats.solution, np.asarray(jstats.solution),
                               rtol=1e-7, atol=1e-9)
    assert _log_lines(tlog) == _log_lines(jlog)


@pytest.mark.parametrize("name", sorted(JAX_CASES))
def test_problem_matches_jax(name, jax_solves):
    jbuild, tbuild = JAX_CASES[name]
    jstats, _ = _jax(jax_solves, name, jbuild, print_level=J.PrintLevel.ERROR)
    tstats = T.madnlp(tbuild(), device="cpu", print_level=T.PrintLevel.ERROR)
    _same(tstats, jstats)


@pytest.mark.parametrize("problem", PUBLISHED, ids=lambda p: p.__name__)
def test_hs_published_optimum(problem):
    model, f_star = problem()
    stats = T.madnlp(model, device="cpu", print_level=T.PrintLevel.ERROR)
    assert stats.status in (T.Status.SOLVE_SUCCEEDED,
                            T.Status.SOLVED_TO_ACCEPTABLE_LEVEL), stats
    assert abs(stats.objective - f_star) / max(1.0, abs(f_star)) < 1e-5


@pytest.mark.parametrize("build,status,f_star,x_star", [
    (tsuite.nls, "SOLVE_SUCCEEDED", 0.0, None),
    (tsuite.lp_issue75, "SOLVE_SUCCEEDED", 205.0, tsuite.LP_ISSUE75_SOLUTION),
    (tsuite.bound_qp, "SOLVE_SUCCEEDED", 2.0, np.ones(2)),
    (tsuite.unbounded, "DIVERGING_ITERATES", None, None),
], ids=["nls", "lp_issue75", "bound_qp", "unbounded"])
def test_suite_reference_solutions(build, status, f_star, x_star):
    stats = T.madnlp(build(), device="cpu", print_level=T.PrintLevel.ERROR)
    assert stats.status.name == status
    if f_star is not None:
        assert abs(stats.objective - f_star) <= 1e-6 * max(1.0, abs(f_star))
    if x_star is not None:
        np.testing.assert_allclose(stats.solution, x_star, atol=1e-6)


def test_lootsma_reference_solution():
    """Fixed variables and inequalities (tests/test_behavior_suite.py)."""
    stats = T.madnlp(tsuite.lootsma(), device="cpu",
                     print_level=T.PrintLevel.ERROR)
    assert stats.status == T.Status.SOLVE_SUCCEEDED
    tol = np.sqrt(1e-8)
    np.testing.assert_allclose(stats.solution[1:], tsuite.LOOTSMA_SOLUTION,
                               atol=tol, rtol=tol)
    np.testing.assert_allclose(stats.multipliers, tsuite.LOOTSMA_MULTIPLIERS,
                               atol=tol, rtol=tol)
    np.testing.assert_allclose(stats.multipliers_L[1:], 0.0, atol=tol)
    np.testing.assert_allclose(stats.multipliers_U[1:], 0.0, atol=tol)


# -- DENSE against DENSE_CONDENSED (tests/test_condensed.py) ---------------


def _dummy_qp(n, m, fixed_variables=(), equality_cons=(), seed=1):
    """``madnlp_tpu.models.instances.dummy_qp.build`` as a port model."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal(n)
    P = rng.standard_normal((n, n))
    P = P @ P.T + 100.0 * np.eye(n)
    xl, xu = np.zeros(n), np.ones(n)
    gl, gu = np.zeros(m), np.ones(m)
    gu[list(equality_cons)] = 0.0
    xl[list(fixed_variables)] = xu[list(fixed_variables)]
    A = np.zeros((m, n))
    for i in range(m):
        A[i, i], A[i, i + 1] = 1.0, -1.0
    P, q, A = (torch.as_tensor(a) for a in (P, q, A))
    return T.create_model(
        obj=lambda x: 0.5 * x @ (P @ x) + q @ x, n=n, x0=np.zeros(n),
        cons=lambda x: A @ x, m=m, grad=lambda x: P @ x + q,
        jac=lambda x: A, lag_hess=lambda x, y, ow: ow * P,
        lvar=xl, uvar=xu, lcon=gl, ucon=gu)


@pytest.mark.parametrize("build", [
    ths15.build,
    lambda: _dummy_qp(25, 6),
    lambda: _dummy_qp(25, 6, equality_cons=[0, 3]),
    lambda: _dummy_qp(25, 6, fixed_variables=[1, 9]),
], ids=["hs15", "qp", "qp_equalities", "qp_fixed"])
def test_condensed_matches_dense(build):
    opts = dict(device="cpu", print_level=T.PrintLevel.ERROR)
    ref = T.madnlp(build(), kkt_system=T.KKTSystem.DENSE, **opts)
    cond = T.madnlp(build(), kkt_system=T.KKTSystem.DENSE_CONDENSED, **opts)
    assert ref.status == cond.status == T.Status.SOLVE_SUCCEEDED
    assert cond.iter == ref.iter, "golden rule: identical iteration counts"
    np.testing.assert_allclose(cond.solution, ref.solution, rtol=1e-7, atol=1e-7)
    np.testing.assert_allclose(cond.multipliers, ref.multipliers, rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("build,solver", [
    (ths15.build, T.LinearSolver.CHOLESKY),
    (lambda: _dummy_qp(20, 5, equality_cons=[2]), T.LinearSolver.LDL),
], ids=["no_equalities", "equalities"])
def test_condensed_preset(build, solver):
    sv = T.MadNLPSolver(build(), device="cpu", print_level=T.PrintLevel.ERROR)
    assert sv.opts.kkt_system == T.KKTSystem.DENSE_CONDENSED
    assert sv.opts.linear_solver == solver
    assert sv.solve().status == T.Status.SOLVE_SUCCEEDED


# -- the dense-Ybus ACOPF ----------------------------------------------------


@pytest.mark.parametrize("seed,dtype", [(1, "float64"), (2, "float32")])
def test_opf_matches_jax(seed, dtype, jax_solves):
    jstats, _ = _jax(jax_solves, f"opf{seed}", lambda: jopf.build(nb=30, seed=seed),
                     dtype=dtype, print_level=J.PrintLevel.ERROR)
    sv = T.MadNLPSolver(topf.build(nb=30, seed=seed), device="cpu",
                        dtype=dtype, print_level=T.PrintLevel.ERROR)
    assert sv.opts.kkt_system == T.KKTSystem.DENSE_CONDENSED
    assert sv.opts.linear_solver == T.LinearSolver.LDL
    assert sv.opts.ldl_block_size == 64
    _same(sv.solve(), jstats, "exact" if dtype == "float64" else "6%")


# -- entry points and what comes later -------------------------------------


def test_dense_entry_points_need_cuda_unless_told():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA"):
        T.madnlp(readme_model())
    with pytest.raises(RuntimeError, match="CUDA"):
        T.MadNLPSolver(ths15.build(), device="cuda")


@pytest.mark.parametrize("opts", [
    dict(linear_solver=T.LinearSolver.BLOCK_CHOLESKY,
         kkt_system=T.KKTSystem.DENSE),
    dict(linear_solver=T.LinearSolver.HYKKT, kkt_system=T.KKTSystem.DENSE),
    dict(kkt_system=T.KKTSystem.SPARSE_CONDENSED),
    dict(kkt_system=T.KKTSystem.SPARSE_UNREDUCED),
])
def test_dense_later_slices_raise(opts):
    """Slice A4 brought these configurations to the single solve of a
    dense model (HS15 solves); ``solve_batch`` on them stays a later
    slice's (A4b) and raises."""
    solver = T.MadNLPSolver(ths15.build(), device="cpu",
                            print_level=T.PrintLevel.ERROR, **opts)
    assert solver.solve().status == T.Status.SOLVE_SUCCEEDED
    with pytest.raises(NotImplementedError, match="later slice"):
        solver.solve_batch([1.0, 1.1])


def test_dense_solve_batch_raises():
    model = topf.build(nb=10, seed=0, parametric=True)
    solver = T.MadNLPSolver(model, device="cpu")
    with pytest.raises(NotImplementedError, match="later slice"):
        solver.solve_batch([0.9, 1.0])
    stats = solver.solve(params=1.0)   # a parametric dense model solves once
    assert stats.status == T.Status.SOLVE_SUCCEEDED


# -- the full-width configuration of chip_smoke.py -------------------------


@pytest.mark.slow
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_opf600_matches_jax(dtype):
    """nb=600: n=1474, m=1200, one 2674×2674 condensed LDLᵀ per
    factorization (block 128).  Minutes on the CPU."""
    jstats = J.madnlp(jopf.build(nb=600, seed=0), dtype=dtype,
                      print_level=J.PrintLevel.ERROR)
    tstats = T.madnlp(topf.build(nb=600, seed=0), device="cpu", dtype=dtype,
                      print_level=T.PrintLevel.ERROR)
    _same(tstats, jstats, "exact" if dtype == "float64" else "6%")


if __name__ == "__main__":
    # backsolve counts of the Hock–Schittkowski problems and bound_qp in
    # both packages, condensed (the default) and augmented (DENSE)
    import sys

    from madnlp_tpu.models.instances import suite as jsuite

    sys.path.insert(0, "tests")
    cases = [(p.__name__, lambda p=p: _jax_hs(p.__name__), lambda p=p: p()[0])
             for p in [hs01, hs03, hs05, hs06, hs07, hs14, hs33, hs35, hs38,
                       hs52, hs71]]
    cases.append(("bound_qp", jsuite.bound_qp, tsuite.bound_qp))
    for name, jbuild, tbuild in cases:
        for kkt in ("DENSE_CONDENSED", "DENSE"):
            j = J.madnlp(jbuild(), kkt_system=kkt, print_level=J.PrintLevel.ERROR)
            t = T.madnlp(tbuild(), kkt_system=kkt, device="cpu",
                         print_level=T.PrintLevel.ERROR)
            print(f"{name} {kkt}: iterations {j.iter}/{t.iter}, "
                  f"factorizations {j.counters['factorization_cnt']}/"
                  f"{t.counters['factorization_cnt']}, backsolves "
                  f"{j.counters['backsolve_cnt']}/{t.counters['backsolve_cnt']}"
                  " (JAX/port)", flush=True)
