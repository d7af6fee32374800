"""The linear-solve options against the JAX package (helpers in
tests/test_torch_step_options.py): AUTO with ``LU`` and ``QR`` on
``hs15.build()`` (neither solver has inertia, so AUTO takes FREE), and
``ops/refine.py:solve_gmres`` on a fixed 40×40 saddle
system (a seeded SPD block of 20, a constraint block of 10, the
bound-dual blocks of 5 an identity), preconditioned by the inverse of a
perturbed copy: the solution within 1e-10 relative, the same success
flag and count, at 2 and 10 restarts.

``inertia_correction_method`` FREE and IGNORE on the banded
``opf.build_sparse(nb=14, seed=0)`` are in
tests/test_torch_batch_options_inertia.py, beside the batch under the
same options, whose JAX reference they share.

One count is held to the one-ulp spread of both packages
(``tools/spread.py qr --pkg both``: seven runs, as they are and moved by
at most one ulp).  hs15 with QR: the two packages' LAPACK
QR factors differ in the last bits, and the refinement takes 57-60
sweeps in both when every factorized matrix is moved by one ulp (57 in
the JAX package, 58 in the port as they are). Iterations and
factorizations are held exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madnlp_tpu.kkt.vec import KKTVec as JVec
from madnlp_tpu.models.instances import hs15 as jhs15
from madnlp_tpu.ops.refine import solve_gmres as jgmres

import madnlp_tpu_torch as T
from madnlp_tpu_torch.kkt.vec import KKTVec as TVec
from madnlp_tpu_torch.models.instances import hs15 as ths15
from madnlp_tpu_torch.ops.refine import solve_gmres as tgmres

from test_torch_step_options import assert_same, options, solve_both

BACKSOLVE_SPREAD = {"QR": (57, 60)}
GMRES_RTOL = 1e-10


@pytest.mark.parametrize("solver", ["LU", "QR"])
def test_auto_without_inertia_solves_as_jax(solver):
    opts = {"linear_solver": f"LinearSolver.{solver}"}
    assert T.MadNLPSolver(ths15.build(), device="cpu", **options(T, opts)
                          ).kernel.inertia_method == T.InertiaCorrection.FREE
    j, t = solve_both(jhs15.build, ths15.build, opts)
    assert t.status == T.Status.SOLVE_SUCCEEDED
    assert_same(t, j, BACKSOLVE_SPREAD.get(solver))


def _saddle(seed):
    """A 40×40 saddle matrix over (xp 20 | y 10 | zl 5 | zu 5) and a
    perturbed copy's inverse as the preconditioner."""
    rng = np.random.default_rng(seed)
    Q = rng.standard_normal((20, 20))
    A = rng.standard_normal((10, 20))
    K = np.eye(40)
    K[:20, :20] = Q @ Q.T + 20.0 * np.eye(20)
    K[20:30, :20], K[:20, 20:30] = A, A.T
    K[20:30, 20:30] = -1e-2 * np.eye(10)
    E = rng.standard_normal((40, 40))
    return K, np.linalg.inv(K * (1.0 + 1e-3 * (E + E.T)))


SIZES = [20, 10, 5, 5]


def _ops(xp, vec, M, v):
    """``M`` applied to the flat KKTVec ``v`` of the package ``xp``."""
    if xp is torch:
        return vec(*torch.split(torch.tensor(M) @ torch.cat(list(v)), SIZES))
    return vec(*jnp.split(jnp.asarray(M) @ jnp.concatenate(list(v)),
                          np.cumsum(SIZES)[:-1]))


@pytest.mark.parametrize("max_iter", [2, 10])
def test_solve_gmres_matches_jax(max_iter):
    K, P = _saddle(5)
    b = np.split(np.random.default_rng(6).standard_normal(40),
                 np.cumsum(SIZES)[:-1])
    kw = dict(max_iter=max_iter, tol=1e-10, acceptable_tol=1e-5)
    jx, jok, jit = jgmres(lambda v: _ops(jnp, JVec, P, v),
                          lambda v: _ops(jnp, JVec, K, v),
                          JVec(*map(jnp.asarray, b)), **kw)
    tx, tok, tit = tgmres(lambda v: _ops(torch, TVec, P, v),
                          lambda v: _ops(torch, TVec, K, v),
                          TVec(*map(torch.tensor, b)), **kw)
    want = np.concatenate([np.asarray(a) for a in jx])
    got = torch.cat(list(tx)).numpy()
    np.testing.assert_allclose(got, want, rtol=GMRES_RTOL,
                               atol=GMRES_RTOL * np.abs(want).max())
    assert bool(jok) == tok and int(jit) == tit == max_iter
