"""Parity of the port's dense linear algebra (madnlp_tpu_torch/ops/ldlt.py,
ops/dense_solvers.py, ops/dense_kernels.py) and dense KKT systems
(kkt/dense.py, kkt/condensed_dense.py) with the JAX package, on the CPU.

* ``ldlt_factorize`` / ``ldlt_solve`` / ``ldlt_inertia`` against JAX's at
  N ∈ {1, 5, 64, 130} (block 64: padded, one block, three blocks), float32
  and float64, on an SPD matrix, an indefinite saddle matrix, a singular
  one (a zero row and column: an exact zero pivot, counted) and a
  multi-RHS solve.  Factor and solution within 1e-9 (float64) and 2e-4
  (float32) relative to their largest entry: the two packages sum the
  trailing products in different orders.  Inertia exact, padding removed.
* ``dense_solvers`` for LDL, CHOLESKY, LU, QR and EVD against JAX's on the
  same SPD system (solutions within 1e-10 relative), inertia exact, and a
  Cholesky failure on an indefinite one reported as (0, n, 0) by both.
* K7's plain version ``dense_ldlt_plain`` against ``pallas_ldlt(interpret=
  True)`` at (n, m) ∈ {(128, 30), (256, 50)}, float32: factors within 5e-6
  relative to max|K| (the JAX test's own tolerance), inertia exact.
* The KKT round trip (tests/test_kkt.py): assemble, factorize, solve on an
  all-ones right-hand side, and ``K·x ≈ 1`` through the unreduced operator
  within 1e-8, for ``DenseKKT`` and ``DenseCondensedKKT`` on hs15 and a
  dummy QP (20 variables, 5 rows), each solution within 1e-9 of the JAX
  package's on the same inputs.
* The sparse-callback models under default options (``hs15.build_sparse()``,
  the sparse QP, ``opf.build_sparse(nb=30)``): small systems, so the sparse
  preset falls back to LDLᵀ, which ``SparseKKT`` runs on a dense matrix
  assembled by deterministic gathers.  Whole solves against the JAX
  package's: status, iterations, ``factorization_cnt`` and
  ``backsolve_cnt`` exactly, the objective within 1e-8 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import madnlp_tpu as J
from madnlp_tpu.ipm import kernels as JK
from madnlp_tpu.ipm.problem import Scaling as JScaling
from madnlp_tpu.ipm.problem import build_problem as jbuild_problem
from madnlp_tpu.kkt.condensed_dense import DenseCondensedKKT as JCond
from madnlp_tpu.kkt.dense import DenseKKT as JDense
from madnlp_tpu.kkt.vec import KKTVec as JVec
from madnlp_tpu.models.instances import dummy_qp as jqp
from madnlp_tpu.models.instances import hs15 as jhs15
from madnlp_tpu.models.instances import opf as jopf
from madnlp_tpu.models.instances import sparse_qp as jsqp
from madnlp_tpu.ops import dense_solvers as jds
from madnlp_tpu.ops import ldlt as jldlt
from madnlp_tpu.ops.pallas_ldlt import pallas_ldlt
from madnlp_tpu.utils.options import KKTSystem as JKKTSystem
from madnlp_tpu.utils.options import LinearSolver as JLinearSolver
from madnlp_tpu.utils.options import MadNLPOptions as JOptions

import madnlp_tpu_torch as T
from madnlp_tpu_torch import create_model
from madnlp_tpu_torch.ipm import kernels as TK
from madnlp_tpu_torch.ipm.problem import Scaling as TScaling
from madnlp_tpu_torch.ipm.problem import build_problem as tbuild_problem
from madnlp_tpu_torch.kkt.condensed_dense import DenseCondensedKKT as TCond
from madnlp_tpu_torch.kkt.dense import DenseKKT as TDense
from madnlp_tpu_torch.kkt.vec import KKTVec as TVec
from madnlp_tpu_torch.models.instances import hs15 as ths15
from madnlp_tpu_torch.models.instances import opf as topf
from madnlp_tpu_torch.models.instances import sparse_qp as tsqp
from madnlp_tpu_torch.ops import dense_kernels, dense_solvers as tds
from madnlp_tpu_torch.ops import ldlt as tldlt
from madnlp_tpu_torch.utils.options import KKTSystem, LinearSolver, MadNLPOptions

torch.set_num_threads(1)

RTOL = {"float32": 2e-4, "float64": 1e-9}
_JDT = {"float32": jnp.float32, "float64": jnp.float64}
_TDT = {"float32": torch.float32, "float64": torch.float64}

_jldlt_factorize = jax.jit(jldlt.ldlt_factorize, static_argnames="block")


def _rel(a, ref):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return np.abs(a - ref).max(initial=0.0) / max(np.abs(ref).max(initial=0.0),
                                                  1e-300)


def _maxabs(t):
    return float(t.abs().max()) if t.numel() else 0.0


def _matrix(case, n, seed):
    """A seeded symmetric test matrix (numpy float64)."""
    rng = np.random.default_rng(seed)
    if case in ("spd", "multi_rhs"):
        R = rng.standard_normal((n, n))
        return R @ R.T + n * np.eye(n)
    m = max(n // 4, 1) if n > 1 else 0
    H = rng.standard_normal((n - m, n - m))
    H = H @ H.T + n * np.eye(n - m)
    J = rng.standard_normal((m, n - m))
    K = np.block([[H, J.T], [J, -1e-3 * np.eye(m)]])
    if case == "singular":
        # an all-zero row and column: an exactly zero pivot, whatever the
        # rounding of the rows before it
        r = n // 2
        K[r, :] = 0.0
        K[:, r] = 0.0
    return K


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("n", [1, 5, 64, 130])
@pytest.mark.parametrize("case", ["spd", "saddle", "singular", "multi_rhs"])
def test_ldlt_matches_jax(case, n, dtype):
    K = _matrix(case, n, seed=n + len(case))
    rng = np.random.default_rng(7)
    b = rng.standard_normal((n, 3) if case == "multi_rhs" else (n,))
    jf = _jldlt_factorize(jnp.asarray(K, _JDT[dtype]), block=64)
    tf = tldlt.ldlt_factorize(torch.as_tensor(K, dtype=_TDT[dtype]), block=64)
    assert tf.n == jf.n == n and tuple(tf.L.shape) == jf.L.shape
    tol = RTOL[dtype]
    assert _rel(tf.L, jf.L) < tol
    assert _rel(tf.d, jf.d) < tol
    inertia = tldlt.ldlt_inertia(tf)
    assert inertia == tuple(int(v) for v in jldlt.ldlt_inertia(jf))
    if case == "singular":
        assert inertia[1] == 1
        return      # the solve of a singular system is not defined
    jx = jldlt.ldlt_solve(jf, jnp.asarray(b, _JDT[dtype]))
    tx = tldlt.ldlt_solve(tf, torch.as_tensor(b, dtype=_TDT[dtype]))
    assert tuple(tx.shape) == b.shape
    assert _rel(tx, jx) < tol
    if case == "spd":
        assert inertia == (n, 0, 0)
    if case == "saddle" and n > 1:
        assert inertia == (n - n // 4, 0, n // 4)


_SOLVERS = ["LDL", "CHOLESKY", "LU", "QR", "EVD"]


@pytest.mark.parametrize("solver", _SOLVERS)
def test_dense_solvers_match_jax(solver):
    K = _matrix("spd", 40, seed=3)
    b = np.random.default_rng(4).standard_normal((40, 2))
    jf = jds.factorize(jnp.asarray(K), JLinearSolver[solver], block=32)
    tf = tds.factorize(torch.as_tensor(K), LinearSolver[solver], block=32)
    assert _rel(tds.solve(tf, torch.as_tensor(b)), jds.solve(jf, jnp.asarray(b))) < 1e-10
    assert _rel(tds.solve(tf, torch.as_tensor(b[:, 0])),
                jds.solve(jf, jnp.asarray(b[:, 0]))) < 1e-10
    assert tds.has_inertia(LinearSolver[solver]) == jds.has_inertia(
        JLinearSolver[solver])
    if tds.has_inertia(LinearSolver[solver]):
        assert tds.inertia(tf) == tuple(int(v) for v in jds.inertia(jf)) == (40, 0, 0)


@pytest.mark.parametrize("solve_mode", ["trisolve", "inverse"])
def test_cholesky_failure_inertia(solve_mode):
    K = _matrix("saddle", 24, seed=5)
    jf = jds.factorize(jnp.asarray(K), JLinearSolver.CHOLESKY, solve_mode=solve_mode)
    tf = tds.factorize(torch.as_tensor(K), LinearSolver.CHOLESKY, solve_mode=solve_mode)
    assert tds.inertia(tf) == tuple(int(v) for v in jds.inertia(jf)) == (0, 24, 0)
    # a failed factor is NaN in both packages
    assert not torch.isfinite(tds.solve(tf, torch.ones(24, dtype=torch.float64))).any()


@pytest.mark.parametrize("n,m", [(128, 30), (256, 50)])
def test_dense_ldlt_plain_matches_pallas_interpret(n, m):
    rng = np.random.default_rng(n)
    H = rng.standard_normal((n - m, n - m))
    H = H @ H.T + n * np.eye(n - m)
    J = rng.standard_normal((m, n - m))
    K = np.block([[H, J.T], [J, np.zeros((m, m))]]).astype(np.float32)
    jf = pallas_ldlt(jnp.asarray(K), block=128, interpret=True)
    tf = dense_kernels.dense_ldlt_plain(torch.as_tensor(K), block=128)
    scale = np.abs(K).max()
    assert np.abs(tf.L.numpy() - np.asarray(jf.L)).max() / scale < 5e-6
    assert np.abs(tf.d.numpy() - np.asarray(jf.d)).max() / scale < 5e-6
    rec = tf.L[:n, :n] @ torch.diag(tf.d[:n]) @ tf.L[:n, :n].T
    assert float((rec - torch.as_tensor(K)).abs().max()) / scale < 5e-6
    assert tldlt.ldlt_inertia(tf) == tuple(int(v) for v in jldlt.ldlt_inertia(jf)) \
        == (n - m, 0, m)
    # the public function takes the plain version for a CPU tensor
    pf = dense_kernels.dense_ldlt(torch.as_tensor(K), block=128)
    assert torch.equal(pf.L, tf.L) and torch.equal(pf.d, tf.d)
    assert dense_kernels.dense_ldlt_cuda.launches == 0


# -- the KKT round trip (tests/test_kkt.py) --------------------------------


def _dummy_qp_data(n, m, seed=1):
    """The numpy data of ``madnlp_tpu.models.instances.dummy_qp.build``."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal(n)
    P = rng.standard_normal((n, n))
    P = P @ P.T + 100.0 * np.eye(n)
    A = np.zeros((m, n))
    for i in range(m):
        A[i, i] = 1.0
        A[i, i + 1] = -1.0
    return P, q, A


def _tdummy_qp(n, m):
    """The dummy QP as a port model (explicit derivatives, as in JAX's)."""
    P, q, A = (torch.as_tensor(a) for a in _dummy_qp_data(n, m))
    return create_model(
        obj=lambda x: 0.5 * x @ (P @ x) + q @ x, n=n, x0=np.zeros(n),
        cons=lambda x: A @ x, m=m, grad=lambda x: P @ x + q,
        jac=lambda x: A, lag_hess=lambda x, y, ow: ow * P,
        lvar=np.zeros(n), uvar=np.ones(n), lcon=np.zeros(m), ucon=np.ones(m))


_MODELS = {"hs15": (jhs15.build, ths15.build),
           "dummy_qp": (lambda: jqp.build(20, 5), lambda: _tdummy_qp(20, 5))}


def _contexts(name, kkt_system, solver):
    """Both packages' KKT system and context at the same interior point,
    with the δ_w ladder of tests/test_kkt.py."""
    jmodel, tmodel = (f() for f in _MODELS[name])
    jopts = JOptions(linear_solver=JLinearSolver[solver],
                     kkt_system=JKKTSystem[kkt_system]).resolve(
                         dense_callback=True, m=jmodel.m)
    topts = MadNLPOptions(linear_solver=LinearSolver[solver],
                          kkt_system=KKTSystem[kkt_system]).resolve(
                              dense_callback=True, m=tmodel.m)
    jprob = jbuild_problem(jmodel, jopts)
    tprob = tbuild_problem(tmodel, topts, "cpu")
    jcls, tcls = ((JCond, TCond) if kkt_system == "DENSE_CONDENSED"
                  else (JDense, TDense))
    jkkt, tkkt = jcls(jprob, jopts), tcls(tprob, topts)
    xl, xu = jprob.xl0.copy(), jprob.xu0.copy()
    xl_f = np.where(jprob.lb_mask, xl, 0.0)
    xu_f = np.where(jprob.ub_mask, xu, 0.0)
    w0 = np.where(jprob.lb_mask & jprob.ub_mask, 0.5 * (xl_f + xu_f),
                  np.where(jprob.lb_mask, xl_f + 1.0,
                           np.where(jprob.ub_mask, xu_f - 1.0, 0.3)))
    y = np.random.default_rng(0).standard_normal(jprob.m)
    jscal = JScaling(jnp.ones(()), jnp.ones((jprob.m,)))
    tscal = TScaling(1.0, torch.ones(tprob.m, dtype=torch.float64))
    jw, tw = jnp.asarray(w0), torch.as_tensor(w0)
    jjac, jhess = jprob.eval_jac(jscal, jw), jprob.eval_lag_hess(jscal, jw, jnp.asarray(y))
    tjac, thess = tprob.eval_jac(tscal, tw), tprob.eval_lag_hess(tscal, tw, torch.as_tensor(y))
    assert _rel(tjac, jjac) < 1e-14 and _rel(thess, jhess) < 1e-12
    lbj, ubj = jnp.asarray(jprob.lb_mask), jnp.asarray(jprob.ub_mask)
    lbt, ubt = torch.as_tensor(tprob.lb_mask), torch.as_tensor(tprob.ub_mask)
    jdl, jdu = JK.slacks(jw, jnp.asarray(xl), jnp.asarray(xu), lbj, ubj)
    tdl, tdu = TK.slacks(tw, torch.as_tensor(xl), torch.as_tensor(xu), lbt, ubt)
    jzl, jzu = jnp.where(lbj, 1.0, 0.0), jnp.where(ubj, 1.0, 0.0)
    tzl, tzu = lbt.double(), ubt.double()
    jfactorize = jax.jit(jkkt.build_and_factorize)
    for reg_val in (1.0, 10.0, 100.0, 1000.0):
        jctx = jfactorize(
            jhess, jjac, jnp.full((jprob.nw,), reg_val), jnp.zeros((jprob.m,)),
            jdl, jdu, jzl, jzu)
        tctx = tkkt.build_and_factorize(
            thess, tjac, torch.full((tprob.nw,), reg_val, dtype=torch.float64),
            torch.zeros(tprob.m, dtype=torch.float64), tdl, tdu, tzl, tzu)
        inertia = tkkt.inertia(tctx)
        assert inertia == tuple(int(v) for v in jkkt.inertia(jctx))
        if tkkt.is_inertia_correct(*inertia):
            break
    assert tkkt.is_inertia_correct(*inertia)
    return jprob, jkkt, jctx, tprob, tkkt, tctx


@pytest.mark.parametrize("name", sorted(_MODELS))
@pytest.mark.parametrize("kkt_system,solver", [
    ("DENSE", "LDL"), ("DENSE", "EVD"), ("DENSE_CONDENSED", "CHOLESKY"),
    ("DENSE_CONDENSED", "LDL")])
def test_kkt_roundtrip_matches_jax(name, kkt_system, solver):
    jprob, jkkt, jctx, tprob, tkkt, tctx = _contexts(name, kkt_system, solver)
    lb = torch.as_tensor(tprob.lb_mask).double()
    ub = torch.as_tensor(tprob.ub_mask).double()
    ones = TVec(xp=torch.ones(tprob.nw, dtype=torch.float64),
                y=torch.ones(tprob.m, dtype=torch.float64), zl=lb, zu=ub)
    x = tkkt.solve(tctx, ones)
    back = tkkt.mul(tctx, x)
    assert max(_maxabs(a - b) for a, b in zip(back, ones)) < 1e-8
    jx = jax.jit(jkkt.solve)(jctx, JVec(*(jnp.asarray(v.numpy()) for v in ones)))
    for a, b in zip(x, jx):
        assert _rel(a, b) < 1e-9
    # the refined solve converges on a general right-hand side
    rhs = TVec(xp=torch.ones(tprob.nw, dtype=torch.float64),
               y=torch.full((tprob.m,), 0.5, dtype=torch.float64),
               zl=-lb, zu=2.0 * ub)
    sol, converged, iters = tkkt.solve_refine(tctx, rhs)
    assert converged and iters >= 1
    r = tkkt.mul(tctx, sol)
    assert max(_maxabs(a - b) for a, b in zip(rhs, r)) < 1e-8


# -- sparse models under default options: the LDLᵀ fallback ----------------

SPARSE_CASES = {
    "hs15": (jhs15.build_sparse, ths15.build_sparse),
    "sparse_qp": (lambda: jsqp.build(n=60, m=15),
                  lambda: tsqp.build(n=60, m=15)),
    "opf": (lambda: jopf.build_sparse(nb=30), lambda: topf.build_sparse(nb=30)),
}


@pytest.mark.parametrize("name", sorted(SPARSE_CASES))
def test_sparse_default_options_match_jax(name):
    jbuild, tbuild = SPARSE_CASES[name]
    jstats = J.madnlp(jbuild(), print_level=J.PrintLevel.ERROR)
    sv = T.MadNLPSolver(tbuild(), device="cpu", print_level=T.PrintLevel.ERROR)
    assert sv.opts.kkt_system == T.KKTSystem.SPARSE
    assert sv.opts.linear_solver == T.LinearSolver.LDL
    assert not sv.kernel.kkt.banded
    tstats = sv.solve()
    assert tstats.status.name == jstats.status.name == "SOLVE_SUCCEEDED"
    assert tstats.iter == jstats.iter
    for c in ("factorization_cnt", "backsolve_cnt"):
        assert tstats.counters[c] == jstats.counters[c], c
    assert abs(tstats.objective - jstats.objective) <= 1e-8 * abs(jstats.objective)
