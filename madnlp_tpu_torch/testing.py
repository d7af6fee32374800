"""Public test harness — port of ``madnlp_tpu/testing.py``: contract
checks users run against their own linear solvers, KKT systems and option
combinations (``test_linear_solver``, ``test_kkt_system``), and the
behavior suite of pathological models with reference solutions
(``BEHAVIOR_SUITE``, ``run_behavior_suite``).  Every check takes
``device`` and runs on the card by default, like the solver::

    import madnlp_tpu_torch.testing as mt

    mt.test_linear_solver(LinearSolver.LDL)              # K7 on the card
    mt.test_kkt_system(kkt_system=KKTSystem.DENSE, linear_solver="ldl")
    mt.run_behavior_suite(device="cpu", kkt_system=KKTSystem.DENSE)

It also holds the seeded fixtures shared by the port's tests and
``chip_smoke.py``: ``band_system`` (a band matrix for the banded kernels)
and ``minsurf_nl`` (the text ``.nl`` file of a COPS minimal surface).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .ipm import kernels as _K
from .ipm.problem import Scaling
from .ipm.solver import MadNLPSolver, madnlp, resolve_device
from .kkt.vec import KKTVec
from .models.instances import dummy_qp, hs15, suite
from .utils.options import KKTSystem, LinearSolver
from .utils.status import Status

__all__ = [
    "test_linear_solver", "test_kkt_system", "run_behavior_suite",
    "BEHAVIOR_SUITE", "ctx_dtype", "dummy_qp", "hs15", "suite",
]


def test_linear_solver(linear_solver: LinearSolver, dtype=torch.float64,
                       rtol: float = 1e-8, device=None):
    """Contract check for a dense factorization backend: factorize/solve a
    fixed 2×2 SPD system and verify the solution and (if supported) the
    inertia — the JAX package's ``test_linear_solver``.  The range-space
    solvers ``BLOCK_CHOLESKY`` and ``HYKKT`` factorize the 2×2 saddle
    structure, so they take a fixed quasidefinite 3×3 system ``[W Aᵀ; A
    -δ]`` split at 2 instead (HYKKT's K_γ through K7 on the card)."""
    from .ops import dense_solvers as ds

    device = resolve_device(device)
    if linear_solver in (LinearSolver.BLOCK_CHOLESKY, LinearSolver.HYKKT):
        A = torch.tensor(
            [[1.0, 0.1, 1.0], [0.1, 2.0, -1.0], [1.0, -1.0, -1e-8]],
            dtype=dtype, device=device,
        )
        b = torch.tensor([1.0, 3.0, 0.5], dtype=dtype, device=device)
        x_ref = np.linalg.solve(A.cpu().double().numpy(),
                                b.cpu().double().numpy())
        factor = ds.factorize(A, linear_solver, split=2)
        x = ds.solve(factor, b)
        np.testing.assert_allclose(
            x.cpu().numpy(), x_ref, rtol=max(rtol, 1e-6), atol=1e-6
        )
        pos, zero, neg = ds.inertia(factor)
        assert (int(pos), int(zero), int(neg)) == (2, 0, 1), (
            f"{linear_solver}: wrong inertia for quasidefinite system"
        )
        return True
    A = torch.tensor([[1.0, 0.1], [0.1, 2.0]], dtype=dtype, device=device)
    b = torch.tensor([1.0, 3.0], dtype=dtype, device=device)
    x_ref = np.linalg.solve(A.cpu().double().numpy(),
                            b.cpu().double().numpy())
    factor = ds.factorize(A, linear_solver)
    x = ds.solve(factor, b)
    np.testing.assert_allclose(x.cpu().numpy(), x_ref, rtol=max(rtol, 1e-6))
    if ds.has_inertia(linear_solver):
        pos, zero, neg = ds.inertia(factor)
        assert (int(pos), int(zero), int(neg)) == (2, 0, 0), (
            f"{linear_solver}: wrong inertia for SPD system"
        )
    return True


def test_kkt_system(
    model=None,
    kkt_system: Optional[KKTSystem] = None,
    linear_solver: Optional[LinearSolver] = None,
    rtol: float = 1e-8,
    check_inertia: bool = True,
    device=None,
    **options,
):
    """KKT-interface contract check (the JAX package's ``test_kkt_system``):
    evaluate derivatives at an interior point, ``build_and_factorize``,
    ``solve`` on an all-ones RHS, then verify the round trip ``mul(kkt, x)
    ≈ 1`` through the *unreduced* operator, plus inertia correctness under
    unit regularization.

    Works for any model/KKT/linear-solver combination accepted by
    :class:`MadNLPSolver`; pass your own ``model`` to exercise a custom
    callback implementation."""
    if model is None:
        # convex QP fixture, so the saddle inertia (nw, 0, m) is guaranteed
        # under unit regularization
        model = dummy_qp.build(20, 5)
    if kkt_system is not None:
        options["kkt_system"] = kkt_system
    if linear_solver is not None:
        options["linear_solver"] = linear_solver
    solver = MadNLPSolver(model, device=device, **options)
    prob, kkt = solver.prob, solver.kernel.kkt
    dev = prob.device

    def t(a):
        return torch.as_tensor(np.asarray(a), device=dev)

    # interior point: midpoint of bounds where two-sided, else 1 inside
    xl, xu = prob.xl0.copy(), prob.xu0.copy()
    with np.errstate(invalid="ignore"):
        w0 = np.where(
            prob.lb_mask & prob.ub_mask, 0.5 * (xl + xu),
            np.where(prob.lb_mask, xl + 1.0,
                     np.where(prob.ub_mask, xu - 1.0, 0.3)),
        )
    scal = Scaling(1.0, prob.zeros(prob.m) + 1.0)
    y = t(np.random.default_rng(0).standard_normal(prob.m))
    jac = prob.eval_jac(scal, t(w0))
    hess = prob.eval_lag_hess(scal, t(w0), y)
    lb, ub = t(prob.lb_mask), t(prob.ub_mask)
    dl, du_ = _K.slacks(t(w0), t(xl), t(xu), lb, ub)
    zl = torch.where(lb, 1.0, 0.0).to(torch.float64)
    zu = torch.where(ub, 1.0, 0.0).to(torch.float64)
    reg = prob.zeros(prob.nw) + 1.0
    ctx = kkt.build_and_factorize(hess, jac, reg, prob.zeros(prob.m), dl,
                                  du_, zl, zu)

    ones = KKTVec(xp=prob.zeros(prob.nw) + 1.0, y=prob.zeros(prob.m) + 1.0,
                  zl=zl, zu=zu)
    x = kkt.solve(ctx, ones)
    back = kkt.mul(ctx, x)
    err = max(
        float((back.xp - ones.xp).abs().max()),
        float((back.y - ones.y).abs().max()) if prob.m else 0.0,
        float((back.zl - ones.zl).abs().max()),
        float((back.zu - ones.zu).abs().max()),
    )
    assert err < max(rtol, 10 * torch.finfo(ctx_dtype(kkt, ctx)).eps), (
        f"KKT round-trip error {err:.3e} for {type(kkt).__name__}"
    )
    if check_inertia and kkt.has_inertia():
        pos, zero, neg = kkt.inertia(ctx)
        assert bool(kkt.is_inertia_correct(pos, zero, neg)), (
            f"{type(kkt).__name__}: inertia "
            f"({int(pos)},{int(zero)},{int(neg)}) not correct under unit "
            "regularization (pass check_inertia=False for nonconvex fixtures)"
        )
    return True


def ctx_dtype(kkt, ctx):
    """Factorization dtype of a KKT context (its first floating tensor, the
    factor's before the operator's)."""
    def leaves(v):
        if isinstance(v, torch.Tensor):
            yield v
        elif isinstance(v, (tuple, list)):
            for c in v:
                yield from leaves(c)

    for leaf in leaves(ctx.factor):
        if leaf.is_floating_point():
            return leaf.dtype
    return torch.float64


# behavior-suite registry: name -> (model factory, checker)
def _check_lootsma(stats):
    tol = np.sqrt(1e-8)
    assert stats.status == Status.SOLVE_SUCCEEDED
    np.testing.assert_allclose(
        stats.solution[1:], suite.LOOTSMA_SOLUTION, atol=tol, rtol=tol
    )
    np.testing.assert_allclose(
        stats.multipliers, suite.LOOTSMA_MULTIPLIERS, atol=tol, rtol=tol
    )


def _check_eigmina(stats):
    assert stats.status == Status.SOLVE_SUCCEEDED
    np.testing.assert_allclose(stats.objective, 1.0, atol=1e-6)


def _check_hs15(stats):
    assert stats.status == Status.SOLVE_SUCCEEDED
    assert abs(stats.objective - hs15.SOLUTION_OBJ_FROM_ZERO) < 1e-4


def _check_infeasible(stats):
    assert stats.status == Status.INFEASIBLE_PROBLEM_DETECTED


def _check_unbounded(stats):
    assert stats.status == Status.DIVERGING_ITERATES


def _check_lp_issue75(stats):
    assert stats.status == Status.SOLVE_SUCCEEDED
    np.testing.assert_allclose(stats.solution, suite.LP_ISSUE75_SOLUTION,
                               atol=1e-6)


def _check_bound_qp(stats):
    assert stats.status == Status.SOLVE_SUCCEEDED
    np.testing.assert_allclose(stats.solution, [1.0, 1.0], atol=1e-6)


def _check_chain(stats):
    assert stats.status == Status.SOLVE_SUCCEEDED
    assert abs(stats.objective - 5.0685) < 2e-2  # COPS reference optimum


def _check_elec(stats):
    # Thomson N=15: global minimum ~ 80.6702 (local minima nearby)
    assert stats.status == Status.SOLVE_SUCCEEDED
    assert 80.0 < stats.objective < 82.0


def _cops():
    from .models.instances import cops

    return cops


BEHAVIOR_SUITE = {
    "hs15": (hs15.build, _check_hs15),
    "lootsma": (suite.lootsma, _check_lootsma),
    "eigmina": (suite.eigmina, _check_eigmina),
    "infeasible": (suite.infeasible, _check_infeasible),
    "unbounded": (suite.unbounded, _check_unbounded),
    "lp_issue75": (suite.lp_issue75, _check_lp_issue75),
    "bound_qp": (suite.bound_qp, _check_bound_qp),
    # COPS-family structural variety (collocation chain, many small
    # equalities); see models/instances/cops.py
    "cops_chain": (lambda: _cops().chain(nh=50), _check_chain),
    "cops_elec": (lambda: _cops().elec(np_=15, seed=0), _check_elec),
}


def run_behavior_suite(exclude=(), device=None, **options):
    """Run the pathological-model behavior suite under the given options on
    ``device`` (the card by default).  Raises on the first mismatch;
    returns ``{name: ExecutionStats}`` on success."""
    options.setdefault("print_level", "ERROR")
    results = {}
    for name, (factory, check) in BEHAVIOR_SUITE.items():
        if name in exclude:
            continue
        stats = madnlp(factory(), device=device, **options)
        try:
            check(stats)
        except AssertionError as e:
            raise AssertionError(f"behavior suite '{name}' failed: {e}") from e
        results[name] = stats
    return results


def band_system(seed: int, N: int, b: int, bw: int, signs: bool = True,
                zero_row: int = None, density: float = 0.4):
    """Lower COO ``(rows, cols, vals)`` of a strictly diagonally dominant
    symmetric band matrix of order ``N`` with scalar bandwidth ``bw·b − 1``
    (as ``benchmarks/tpu_pallas_check.py`` builds them): off-diagonal
    entries N(0, 0.1²) kept with probability ``density``, diagonal
    1.1·(row |off-diagonal| sum) + 1, so unpivoted LDLᵀ is stable and only
    summation order separates two implementations.  ``signs`` negates a
    random third of the diagonal (an indefinite matrix whose inertia is
    non-trivial); ``zero_row`` empties one row and column (an exactly zero
    pivot, which divides as inf)."""
    rng = np.random.default_rng(seed)
    W = bw * b - 1
    i = np.repeat(np.arange(N), W + 1)
    j = i - np.tile(np.arange(W + 1), N)
    keep = (j >= 0) & ((j == i) | (rng.random(len(i)) < density))
    rows, cols = i[keep], j[keep]
    vals = rng.standard_normal(len(rows)) * 0.1
    off = rows != cols
    rowsum = np.zeros(N)
    np.add.at(rowsum, rows[off], np.abs(vals[off]))
    np.add.at(rowsum, cols[off], np.abs(vals[off]))
    diag = 1.1 * rowsum[rows[~off]] + 1.0
    if signs:
        diag = diag * np.where(rng.random(N) < 1 / 3, -1.0, 1.0)
    vals[~off] = diag
    if zero_row is not None:
        vals[(rows == zero_row) | (cols == zero_row)] = 0.0
    return rows, cols, vals


def minsurf_nl(nx: int, obstacle: bool = True) -> str:
    """Text ``.nl`` file of the COPS minimal surface with obstacle on an
    ``nx × nx`` grid (``models.instances.cops.minsurf``), written the way
    AMPL writes an indexed model: the objective is one OPSUMLIST of the
    2·nx² cell terms ``0.5·h²·sqrt(1 + vx² + vy²)`` over the two triangles
    of each cell, as ``cops.minsurf`` forms them (``vx = (a − b)/h``);
    the boundary is fixed by equal bounds, the centre patch held at ``v ≥
    1`` with ``obstacle``, and x0 is ``cops.minsurf``'s.  Variable
    ``i·(nx+1) + j`` is the grid node (i, j)."""
    n1 = nx + 1
    n = n1 * n1
    h = 1.0 / nx
    xs = np.linspace(0.0, 1.0, n1)
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    boundary = (X == 0) | (X == 1) | (Y == 0) | (Y == 1)
    patch = (X >= 0.25) & (X <= 0.75) & (Y >= 0.25) & (Y <= 0.75)
    lower = (patch & ~boundary).reshape(-1) if obstacle else np.zeros(n, bool)
    fixed = boundary.reshape(-1)
    x0 = np.where(boundary, 0.0, 1.0).reshape(-1)

    def v(i, j):
        return f"v{i * n1 + j}"

    def sq_diff(a, b):
        return ["o5", "o3", "o1", a, b, f"n{h!r}", "n2"]

    def area(a, b, c, d):
        # 0.5 h² · sqrt(1 + ((a − b)/h)² + ((c − d)/h)²)
        return (["o2", f"n{0.5 * h * h!r}", "o39", "o54", "3", "n1"]
                + sq_diff(a, b) + sq_diff(c, d))

    lines = [
        "g3 1 1 0\t# problem minsurf",
        f" {n} 0 1 0 0\t# vars, constraints, objectives, ranges, eqns",
        " 0 1\t# nonlinear constraints, objectives",
        " 0 0\t# network constraints: nonlinear, linear",
        f" 0 {n} 0\t# nonlinear vars in constraints, objectives, both",
        " 0 0 0 1\t# linear network variables; functions; arith, flags",
        " 0 0 0 0 0\t# discrete variables: binary, integer, nonlinear (b,c,o)",
        f" 0 {n}\t# nonzeros in Jacobian, gradients",
        " 0 0\t# max name lengths: constraints, variables",
        " 0 0 0 0 0\t# common exprs: b,c,o,c1,o1",
        "O0 0", "o54", str(2 * nx * nx),
    ]
    for i in range(nx):
        for j in range(nx):
            lines += area(v(i + 1, j + 1), v(i, j + 1),
                          v(i + 1, j + 1), v(i + 1, j))
            lines += area(v(i + 1, j), v(i, j), v(i, j + 1), v(i, j))
    nz = np.nonzero(x0)[0]
    lines.append(f"x{len(nz)}")
    lines += [f"{k} {float(x0[k])!r}" for k in nz]
    lines.append("b")
    lines += ["4 0" if fixed[k] else "2 1" if lower[k] else "3"
              for k in range(n)]
    lines.append(f"k{n - 1}")
    lines += ["0"] * (n - 1)
    lines.append(f"G0 {n}")
    lines += [f"{k} 0" for k in range(n)]
    return "\n".join(lines) + "\n"
