"""The range-space dense solvers of slice A4 (``ops/dense_solvers.py``:
BLOCK_CHOLESKY and HYKKT) against the JAX package's on the same inputs.

Saddle matrices ``K = [W Aᵀ; A C]`` (C = −δ·I) are made by numpy from a
seed; each JAX configuration runs factorize, solve and inertia in one
``jax.jit`` (one compile per configuration, at XLA's backend optimization
level 0).  The factor payloads, the
solves and the inertia are compared: float64 within 1e-12 relative,
float32 within 1e-5 (HYKKT's float32 CG solve: within 4× the JAX
package's own error against the exact solution, the one-ulp sensitivity of
a solve through a float32 K_γ being 1e-5 to 1e-4), the inertia exactly.

* BLOCK_CHOLESKY in both solve modes and dtypes; a rank-deficient Jacobian
  (two equal rows, C = 0: a singular Schur block), whose failed Schur
  pivots ``nz2`` are the inertia's zero count and must match exactly; an
  indefinite W (the δ_w ladder's case: inertia (0, n, 0)).
* HYKKT with the ``"native"`` backend (``cholesky_ex``) and the ``"ldl"``
  one (the blocked LDLᵀ: K7's plain version here, the JAX package's XLA
  ``ldlt_factorize`` there), in both solve modes: γ, the success flag, the
  multi-column float64 CG and its result; the ``rr`` mode (K_c, the direct
  elimination); a K_γ that is not positive definite.  The CG reads one host
  scalar per iteration (``CG_STATS``).
* ``hykkt_backend=None`` resolves by the tensor's device (``"native"`` on
  the CPU), and a range-space solver without a split raises as there.
"""

import numpy as np
import pytest
import torch

from madnlp_tpu_torch.ops import dense_solvers as ds
from madnlp_tpu_torch.utils.options import LinearSolver

torch.set_num_threads(1)

TOL = {"float64": 1e-12, "float32": 1e-5}
NW, M = 24, 10
_JIT = {}
# the JAX functions compiled at XLA's backend optimization level 0: the
# same program (its results within rounding of the default build's: 1e-13
# relative on a HYKKT solve) at about half the backend compile time, for
# the slice's test budget
FAST_COMPILE = {"xla_backend_optimization_level": 0}


def _saddle(seed, dtype="float64", indefinite_w=False, equal_rows=False,
            delta=1e-8):
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((NW, NW))
    W = G @ G.T / NW + np.eye(NW)
    if indefinite_w:
        W -= 3.0 * np.eye(NW)
    A = rng.standard_normal((M, NW))
    if equal_rows:
        A[1] = A[0]
    K = np.block([[W, A.T], [A, -delta * np.eye(M)]])
    B = rng.standard_normal((NW + M, 3))
    return K.astype(dtype), B.astype(dtype)


def _jax(K, B, solver, **kw):
    """The JAX package's factor, solve and inertia of ``K``, one jit per
    configuration."""
    import jax
    import jax.numpy as jnp

    from madnlp_tpu.ops import dense_solvers as jds
    from madnlp_tpu.utils.options import LinearSolver as JLS

    key = (solver.name, tuple(sorted(kw.items())), K.dtype.name)
    K, B = jnp.asarray(K), jnp.asarray(B)
    if key not in _JIT:
        def run(K, B):
            f = jds.factorize(K, getattr(JLS, solver.name), **kw)
            return f, jds.solve(f, B), jnp.stack(
                [jnp.asarray(v, jnp.int64) for v in jds.inertia(f)])
        _JIT[key] = jax.jit(run).lower(K, B).compile(FAST_COMPILE)
    f, x, inertia = _JIT[key](K, B)
    return f, np.asarray(x), tuple(int(v) for v in np.asarray(inertia))


def _port(K, B, solver, **kw):
    f = ds.factorize(torch.as_tensor(K), solver, **kw)
    return f, ds.solve(f, torch.as_tensor(B)).numpy(), ds.inertia(f)


def _close(a, b, dtype, what):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, what
    scale = max(np.abs(b).max(), 1e-300)
    err = np.abs(a - b).max() / scale
    assert err <= TOL[dtype], f"{what}: relative error {err:.3e}"


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("mode", ["trisolve", "inverse"])
def test_block_cholesky_matches_jax(mode, dtype):
    K, B = _saddle(1, dtype)
    kw = dict(split=NW, solve_mode=mode)
    jf, jx, ji = _jax(K, B, LinearSolver.BLOCK_CHOLESKY, **kw)
    tf, tx, ti = _port(K, B, LinearSolver.BLOCK_CHOLESKY, **kw)
    assert tf.kind == jf.kind == ("bchol_inv" if mode == "inverse"
                                  else "bchol")
    _close(tf.a.numpy(), jf.a, dtype, "L1")
    _close(tf.b.numpy(), jf.b, dtype, "X, L2, flags")
    _close(tx, jx, dtype, "solve")
    assert ti == ji == (NW, 0, M)


@pytest.mark.parametrize("case", ["rank_deficient_schur", "indefinite_w"])
def test_block_cholesky_inertia_of_a_failed_block(case):
    """A singular Schur block (equal Jacobian rows, C = 0) rounds to a
    factor with pivots at the noise floor, or to NaN: the count of failed
    pivots is the zero count, exactly the JAX package's.  An indefinite W
    fails L₁: a wrong inertia."""
    if case == "rank_deficient_schur":
        K, B = _saddle(2, equal_rows=True, delta=0.0)
    else:
        K, B = _saddle(3, indefinite_w=True)
    kw = dict(split=NW, solve_mode="trisolve")   # the jit of the cases above
    _, _, ji = _jax(K, B, LinearSolver.BLOCK_CHOLESKY, **kw)
    _, _, ti = _port(K, B, LinearSolver.BLOCK_CHOLESKY, **kw)
    assert ti == ji
    if case == "rank_deficient_schur":
        assert ti[0] == NW and ti[1] >= 1 and sum(ti) == NW + M
    else:
        assert ti == (0, NW + M, 0)


HYKKT_CASES = [
    ("native", "trisolve", "float64"),
    ("native", "inverse", "float64"),
    ("ldl", "trisolve", "float64"),
    ("ldl", "inverse", "float64"),
    ("ldl", "trisolve", "float32"),
]


@pytest.mark.parametrize("backend,mode,dtype", HYKKT_CASES)
def test_hykkt_matches_jax(backend, mode, dtype):
    # γ = 100: the solve's own one-ulp sensitivity (the JAX package
    # against itself on K moved by one ulp) stays near 3e-13; at γ = 1e4
    # K_γ's conditioning lifts it to 1.6e-11, above the float64 tolerance
    K, B = _saddle(4, dtype, delta=1e-6)
    gamma = 1e2
    kw = dict(split=NW, solve_mode=mode, gamma=gamma, hykkt_backend=backend,
              block=16)
    jf, jx, ji = _jax(K, B, LinearSolver.HYKKT, **kw)
    ds.reset_cg_stats()
    tf, tx, ti = _port(K, B, LinearSolver.HYKKT, **kw)
    assert tf.kind == jf.kind
    assert tf.meta[:2] == tuple(jf.meta)
    assert tf.meta[2] is False
    _close(tf.a.numpy(), jf.a, dtype, "K_γ factor")
    _close(tf.b.numpy(), jf.b, dtype, "Aᵀ, c, γ, ok, rr")
    # 0.5/max(−c) = 5e5 > γ: the requested γ stands
    assert float(tf.b[NW + 1, 0]) == pytest.approx(gamma, rel=1e-7)
    if dtype == "float64":
        _close(tx, jx, dtype, "CG solve")
    else:
        # K_γ⁻¹ in float32: a one-ulp move of K moves the JAX package's own
        # solve by 1e-5 to 1e-4 here, so the port's solve is held to the
        # JAX package's accuracy against the exact solution instead
        ex = np.linalg.solve(K.astype(np.float64), B.astype(np.float64))
        err = np.abs(tx - ex).max() / np.abs(ex).max()
        jerr = np.abs(jx - ex).max() / np.abs(ex).max()
        assert err <= max(4.0 * jerr, TOL[dtype]), (err, jerr)
    assert ti == ji == (NW, 0, M)
    # one host read per CG iteration, plus the first
    st = ds.CG_STATS
    assert st["solves"] == 1 and 0 < st["iterations"] < 200
    assert st["host_reads"] == st["iterations"] + 1


@pytest.mark.parametrize("backend", ["native", "ldl"])
def test_hykkt_restoration_mode_matches_jax(backend):
    """``rr=True``: K_c = W + Aᵀ(−C)⁻¹A, γ = 0, a direct solve (no CG)."""
    K, B = _saddle(5, delta=0.5)
    kw = dict(split=NW, rr=True, hykkt_backend=backend, block=16)
    jf, jx, ji = _jax(K, B, LinearSolver.HYKKT, **kw)
    ds.reset_cg_stats()
    tf, tx, ti = _port(K, B, LinearSolver.HYKKT, **kw)
    assert tf.meta[2] is True and float(tf.b[NW + 3, 0]) == 1.0
    _close(tf.a.numpy(), jf.a, "float64", "K_c factor")
    _close(tf.b.numpy(), jf.b, "float64", "Aᵀ, c, γ, ok, rr")
    _close(tx, jx, "float64", "direct solve")
    assert ti == ji == (NW, 0, M)
    assert ds.CG_STATS["solves"] == 0
    x = np.linalg.solve(K, B)
    np.testing.assert_allclose(tx, x, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("backend", ["native", "ldl"])
def test_hykkt_failed_factor_is_a_wrong_inertia(backend):
    K, B = _saddle(6, indefinite_w=True)
    K[:NW, :NW] -= 50.0 * np.eye(NW)   # W ≺ 0 on null(A): no γ helps
    kw = dict(split=NW, solve_mode="trisolve", gamma=1e2,
              hykkt_backend=backend, block=16)   # the jit of the cases above
    _, _, ji = _jax(K, B, LinearSolver.HYKKT, **kw)
    tf, _, ti = _port(K, B, LinearSolver.HYKKT, **kw)
    assert ti == ji == (0, NW + M, 0)
    assert float(tf.b[NW + 2, 0]) == 0.0


def test_backend_resolution_and_split():
    assert ds.resolve_hykkt_backend(None, "cpu") == "native"
    assert ds.resolve_hykkt_backend(None, "cuda") == "ldl"
    assert ds.resolve_hykkt_backend("ldl", "cpu") == "ldl"
    with pytest.raises(ValueError, match="hykkt_backend"):
        ds.resolve_hykkt_backend("cholmod", "cpu")
    K, _ = _saddle(7)
    f = ds.factorize(torch.as_tensor(K), LinearSolver.HYKKT, split=NW)
    assert f.kind == "hykkt"
    for solver in (LinearSolver.HYKKT, LinearSolver.BLOCK_CHOLESKY):
        with pytest.raises(ValueError, match="split"):
            ds.factorize(torch.as_tensor(K), solver)
        z = ds.zero_factor(solver, NW + M, torch.float64, split=NW,
                           hykkt_backend="ldl", block=16)
        f = ds.factorize(torch.as_tensor(K), solver, split=NW,
                         hykkt_backend="ldl", block=16)
        assert z.kind == f.kind and z.a.shape == f.a.shape
        assert z.b.shape == f.b.shape and z.meta == f.meta
