"""The step options inside ``solve_batch``, port only, on the CPU (the
lanes against the JAX package are in tests/test_torch_batch_options.py):

* a chunked and probed batch equals the bulk run bit for bit under the
  quality function and under compact L-BFGS: the per-lane fields
  (``qn``, the low-rank Hessian, ``barrier_free_mode``, the persisted
  context) survive ``take``, ``split_lanes`` and ``stack_lanes``;
* the lane-axis forms against the single ones on seeded inputs, each
  lane within 1e-12 relative: the compact L-BFGS update with its skip
  and reset per lane (a lane outside the mask untouched), the
  Gilbert–Lemaréchal start, and the SMW payload of a batched
  factorization (one batched backsolve of 2p columns) applied to a
  right-hand side.
"""

import dataclasses

import numpy as np
import pytest
import torch

import madnlp_tpu_torch as T
from madnlp_tpu_torch.ipm import quasi_newton as qn
from madnlp_tpu_torch.ipm.state import BatchState, RRState
from madnlp_tpu_torch.models.instances import opf as topf
from madnlp_tpu_torch.utils.options import QuasiNewtonOptions

torch.set_num_threads(1)

RTOL = 1e-12


def _assert_same(a, b, where=""):
    """Two batch states (or parts of them) equal bit for bit."""
    if isinstance(a, (BatchState, RRState)):
        for f in dataclasses.fields(a):
            _assert_same(getattr(a, f.name), getattr(b, f.name),
                         f"{where}.{f.name}")
    elif isinstance(a, tuple):
        assert len(a) == len(b), where
        for i, (u, v) in enumerate(zip(a, b)):
            _assert_same(u, v, f"{where}[{i}]")
    elif torch.is_tensor(a):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True,
                                   msg=where)
    elif a is None:
        assert b is None, where
    else:
        np.testing.assert_array_equal(a, b, err_msg=where)


def _solver(**opts):
    return T.MadNLPSolver(topf.build_sparse(nb=14, seed=0, parametric=True),
                          device="cpu", linear_solver=T.LinearSolver.BANDED,
                          print_level=T.PrintLevel.ERROR,
                          richardson=T.RichardsonOptions(mu_scaled=True),
                          **opts)


@pytest.mark.parametrize("opts", [
    {"barrier": T.BarrierUpdate.QUALITY_FUNCTION},
    {"hessian_approximation": T.HessianApproximation.COMPACT_LBFGS},
], ids=["quality_function", "compact_lbfgs"])
def test_chunked_batch_matches_bulk(opts):
    scales = [1.05, 1.0, 0.95, 0.9]      # reversed: the probe sorts them
    solver = _solver(**opts)
    bulk = solver.solve_batch(scales)
    chunked = solver.solve_batch(scales, chunk_size=2, probe_iters=3)
    assert (bulk.status == int(T.Status.SOLVE_SUCCEEDED)).all()
    if "barrier" in opts:
        assert bulk.ctx is not None
    else:
        assert (bulk.qn.mem > 0).all() and (bulk.hess_cnt == 0).all()
    _assert_same(chunked, bulk)


def _pairs(B, n, p, seed):
    rng = np.random.default_rng(seed)
    s = rng.standard_normal((B, n))
    y = s * rng.uniform(0.5, 2.0, (B, n)) + 0.1 * rng.standard_normal((B, n))
    return torch.as_tensor(s), torch.as_tensor(y)


def _lane(tree, i):
    return type(tree)(*(a[i] if torch.is_tensor(a) else int(a[i])
                        for a in tree))


def _close(got, want, what):
    torch.testing.assert_close(got, want, rtol=RTOL,
                               atol=RTOL * float(want.abs().max()) + 1e-300,
                               msg=what)


def test_lbfgs_update_per_lane_matches_the_single_update():
    """Five updates of four lanes with their own memories (p = 3, so the
    memory fills and shifts): lane 1 takes a negative-curvature pair at
    updates 2 and 3 (two skips: its memory resets), lane 3 is outside the
    mask at update 1 and must stay as it was."""
    B, n, p = 4, 9, 3
    opts = QuasiNewtonOptions(max_history=p)
    lr = qn.lowrank_zeros(n, p, "cpu", lanes=B)
    mem = qn.qn_zeros(n, p, "cpu", lanes=B)
    g0 = torch.as_tensor(np.random.default_rng(3).standard_normal((B, n)))
    f0 = np.array([2.0, 0.0, -1.5, 1e-20])
    every = np.ones(B, dtype=bool)
    lr = qn.init_hessian_lowrank_lanes(lr, g0, f0, 1.0, every)
    singles = []
    for i in range(B):
        one = qn.init_hessian_lowrank(qn.lowrank_zeros(n, p, "cpu"), g0[i],
                                      float(f0[i]))
        _close(lr.diag[i], one.diag, f"start {i}")
        singles.append((one, qn.qn_zeros(n, p, "cpu")))
    for k in range(5):
        s, y = _pairs(B, n, p, 10 + k)
        if k in (2, 3):
            y[1] = -y[1]
        lanes = every.copy()
        if k == 1:
            lanes[3] = False
        before = (lr, mem)
        lr, mem = qn.lbfgs_update_compact_lanes(lr, mem, s, y, opts, lanes)
        for i in range(B):
            if not lanes[i]:
                _assert_same(_lane(lr, i), _lane(before[0], i), "untouched")
                _assert_same(_lane(mem, i), _lane(before[1], i), "untouched")
                continue
            one, m = qn.lbfgs_update_compact(*singles[i], s[i], y[i], opts)
            singles[i] = (one, m)
            assert (int(mem.mem[i]), int(mem.skipped[i])) == (m.mem,
                                                              m.skipped)
            for f in ("diag", "U", "V"):
                _close(getattr(lr, f)[i], getattr(one, f), f"{k} {i} {f}")
            for f in ("Sk", "Yk"):
                _close(getattr(mem, f)[i], getattr(m, f), f"{k} {i} {f}")
    assert mem.mem.tolist() == [3, 1, 3, 3] and mem.skipped[1] == 0


def test_batched_smw_payload_matches_the_single_one():
    """A compact L-BFGS batch's factorization (K3 on the CPU: its plain
    version) carries per lane the single factorization's SMW payload, and
    a batched solve applies it: each lane's solution within 1e-12 of the
    single solve of that lane's system; a lane left out of the
    factorization keeps the previous payload."""
    solver = _solver(
        hessian_approximation=T.HessianApproximation.COMPACT_LBFGS)
    bk = solver.batch_kernel
    st = bk.initialize(torch.tensor([0.95, 1.0, 1.05], dtype=torch.float64))
    for _ in range(3):
        st = bk.step(st)
    assert (st.qn.mem > 0).all()
    kkt = solver.kernel.kkt
    lanes = np.array([True, False, True])
    zeros = np.zeros(3)
    first = bk._factorize(st, zeros, zeros, np.ones(3, dtype=bool), None)
    ctx = bk._factorize(st, zeros + 1e-4, zeros, lanes, first)
    rhs = bk._aug_rhs(st, st.c, st.mu)
    got = kkt.solve(ctx, rhs, np.ones(3, dtype=bool))
    for i in range(3):
        one = st.take([i])
        hess = qn.LowRankHessian(*(a[0] for a in one.hess))
        dl, du_ = solver.kernel.slacks(one.x[0], one.xl[0], one.xu[0])
        reg = one.x.new_zeros(one.x.shape[1]) + (
            solver.opts.default_primal_regularization
            + (1e-4 if lanes[i] else 0.0))
        du_diag = one.y.new_zeros(one.y.shape[1]) \
            - solver.opts.default_dual_regularization
        sctx = kkt.build_and_factorize(hess, one.jac[0], reg, du_diag, dl,
                                       du_, one.zl[0], one.zu[0])
        want = kkt.solve(sctx, type(rhs)(*(a[i] for a in rhs)))
        for part, a, b in zip(rhs._fields, got, want):
            _close(a[i], b, f"lane {i} {part}")
        if not lanes[i]:
            _assert_same(tuple(a[i] for a in _flat(ctx.factor.smw)),
                         tuple(a[i] for a in _flat(first.factor.smw)),
                         "kept payload")


def _flat(tree):
    out = []
    for a in tree:
        out.extend(_flat(a) if isinstance(a, tuple) else [a])
    return out
