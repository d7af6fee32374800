"""The quasi-Newton machinery against the JAX functions on seeded numpy
inputs (helpers in tests/test_torch_step_options.py):

* ``bfgs_update``, plain and damped (the first update re-initializes B),
  over five seeded secant pairs;
* a sequence of compact L-BFGS updates that fills the memory, shifts it,
  skips a pair and resets after two skips in a row, in both forms (the
  formed operator and the factored ``LowRankHessian``);
* ``DenseKKT._attach_smw`` on the SPARSE system's dense storage (LU): E
  exactly, T and a solve through the corrected factor within 1e-9
  relative (two LAPACK LU factorizations of one matrix).

The updates are held within 1e-12 relative: the same float64 formulas,
summed in another order.  ``curvature``, the σ-initialization of the
updates, is held in tests/test_torch_ipm_kernels.py with the other
scalar reductions.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import madnlp_tpu as J
from madnlp_tpu.ipm import quasi_newton as jqn
from madnlp_tpu.kkt.vec import KKTVec as JVec
from madnlp_tpu.models.instances import sparse_qp as jsqp
from madnlp_tpu.utils.options import QuasiNewtonOptions as JQNO

import madnlp_tpu_torch as T
from madnlp_tpu_torch.ipm import quasi_newton as tqn
from madnlp_tpu_torch.kkt.vec import KKTVec as TVec
from madnlp_tpu_torch.models.instances import sparse_qp as tsqp
from madnlp_tpu_torch.utils.options import QuasiNewtonOptions as TQNO

from test_torch_step_options import close, secant_pairs

SMW_RTOL = 1e-9


@pytest.mark.parametrize("damped", [False, True])
def test_bfgs_update_matches_jax(damped):
    n = 7
    B0 = np.eye(n) * 3.0
    tB, tq = torch.tensor(B0), tqn.qn_zeros(n, 0, "cpu")
    jB, jq = jnp.asarray(B0), jqn.qn_zeros(n, 0)
    for s, y in secant_pairs(n, 5, 1):
        tB, tq = tqn.bfgs_update(tB, tq, torch.tensor(s), torch.tensor(y),
                                 damped)
        jB, jq = jqn.bfgs_update(jB, jq, jnp.asarray(s), jnp.asarray(y),
                                 damped)
        close(tB, jB)
        assert tq.instantiated == bool(jq.instantiated)


@pytest.mark.parametrize("form", ["compact", "dense"])
def test_lbfgs_update_matches_jax(form):
    """Eight updates into a memory of 3: fill, shift, skip pair 3
    (sᵀy < 0), then two pairs whose skips reset the memory."""
    n, p = 9, 3
    topts, jopts = TQNO(max_history=p), JQNO(max_history=p)
    if form == "compact":
        tH, jH = tqn.lowrank_zeros(n, p, "cpu"), jqn.lowrank_zeros(n, p)
        tupd, jupd = tqn.lbfgs_update_compact, jqn.lbfgs_update_compact
    else:
        tH, jH = torch.eye(n, dtype=torch.float64), jnp.eye(n)
        tupd, jupd = tqn.lbfgs_update, jqn.lbfgs_update
    tq, jq = tqn.qn_zeros(n, p, "cpu"), jqn.qn_zeros(n, p)
    pairs = secant_pairs(n, 6, 2)
    pairs.append((np.zeros(n), np.ones(n)))       # ‖s‖ = 0: skipped
    pairs.append((np.ones(n), np.zeros(n)))       # ‖y‖ = 0: second skip
    for s, y in pairs:
        tH, tq = tupd(tH, tq, torch.tensor(s), torch.tensor(y), topts)
        jH, jq = jupd(jH, jq, jnp.asarray(s), jnp.asarray(y), jopts)
        for a, b in zip(tuple(tH) if form == "compact" else (tH,),
                        tuple(jH) if form == "compact" else (jH,)):
            close(a, b)
        for f in ("Sk", "Yk", "last_jv"):
            close(getattr(tq, f), getattr(jq, f), f)
        assert (tq.mem, tq.skipped) == (int(jq.mem), int(jq.skipped))
    assert tq.mem == 0      # reset by the two skips in a row


def test_smw_payload_matches_jax():
    from madnlp_tpu.ipm.problem import build_problem as jbuild
    from madnlp_tpu.kkt.sparse import SparseKKT as JKKT
    from madnlp_tpu_torch.ipm.problem import build_problem as tbuild
    from madnlp_tpu_torch.kkt.sparse import SparseKKT as TKKT

    kw = dict(kkt_system="sparse", linear_solver="lu",
              hessian_approximation="compact_lbfgs")
    jo = J.MadNLPOptions.create(**kw).resolve(dense_callback=False, m=5)
    to = T.MadNLPOptions.create(**kw).resolve(dense_callback=False, m=5)
    jp = jbuild(jsqp.build(n=20, m=5), jo)
    tp = tbuild(tsqp.build(n=20, m=5), to, "cpu")
    jk, tk = JKKT(jp, jo), TKKT(tp, to)
    rng = np.random.default_rng(3)
    n, pm, nw, m = tp.n, to.quasi_newton_options.max_history, tp.nw, tp.m
    U = 0.3 * rng.standard_normal((n, pm))
    V = 0.3 * rng.standard_normal((n, pm))
    diag = rng.uniform(1.0, 2.0, n)
    args = dict(
        jac=rng.standard_normal(len(tp.jac_rows_aug)),
        reg=np.full(nw, 1e-8), du_diag=np.full(m, -1e-8),
        dl=rng.uniform(0.5, 1.5, nw), du_=rng.uniform(0.5, 1.5, nw),
        zl=rng.uniform(0.5, 1.5, nw), zu=rng.uniform(0.5, 1.5, nw))
    jctx = jk.build_and_factorize(
        hess=jqn.LowRankHessian(jnp.asarray(diag), jnp.asarray(U),
                                jnp.asarray(V)),
        **{k: jnp.asarray(v) for k, v in args.items()})
    tctx = tk.build_and_factorize(
        hess=tqn.LowRankHessian(torch.tensor(diag), torch.tensor(U),
                                torch.tensor(V)),
        **{k: torch.tensor(v) for k, v in args.items()})
    (jE, jT, _), (tE, tT, _) = jctx.factor.smw, tctx.factor.smw
    np.testing.assert_array_equal(tE.numpy(), np.asarray(jE))
    b = [rng.standard_normal(k) for k in (nw, m, nw, nw)]
    jx = jk.solve(jctx, JVec(*(jnp.asarray(v) for v in b)))
    tx = tk.solve(tctx, TVec(*(torch.tensor(v) for v in b)))
    for a, c in [(tT, jT)] + list(zip(tx, jx)):
        c = np.asarray(c)
        np.testing.assert_allclose(a.numpy(), c, rtol=SMW_RTOL,
                                   atol=SMW_RTOL * np.abs(c).max())
